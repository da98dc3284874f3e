#!/usr/bin/env python3
"""A/B of the two ``tsar_sparse`` CUDA entry points of two checkouts on one GPU.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/tsar_sparse_ab.py build/parent [--new .] [--out build/tsar_sparse_ab.json]

Each checkout is driven through its own ``repro_torch`` package (the
wrappers ``kernels.tsar_sparse.tsar_sparse_padded_matmul_packed`` and
``tsar_sparse_matmul_packed``, and ``kernels.tsar_matmul`` beside them), so
any two revisions compare, each building its kernels from its own sources
into its own ``build/``.  They run in turns, old, new, new, old, each turn in
a process of its own, on the four ``bitnet-2b-4t`` projection shapes with a
seeded half of the (256, 256) blocks dead (numpy seed 0, as
``chip_smoke.py``): the padded entry point at N in {4, 20} on tight pools
(the serving step's), with the dense ``tsar_matmul`` on the same decoded
matrix beside it, and the compacted entry point at N in {1, 4, 20}.  Per
point and turn:

* every call's output ``torch.equal`` to the checkout's plain version
  (``--time-only`` skips this, for a probe tree whose kernel leaves out
  work on purpose and so computes wrong sums);
* device us per call: median of 21 CUDA-graph replays cycling over enough
  pool (or plane) copies to defeat the 50 MB L2 (as ``chip_smoke.py``
  times);
* host us per call of the wrapper: the least of 15 loops of 100 eager calls.

Then the bound (``chip_smoke.sparse_bound``) and its share, the padded
kernel's sums over one serving step (30 layers x 7 projections) and the
compacted kernel's over one layer.  The timing helpers are
``tools/tsar_matmul_ab.py``'s.  Needs ``nvcc`` and a GPU; the card's name
and power limit are printed first and last.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import block_sparse_ternary, sparse_bound  # noqa: E402
from tsar_matmul_ab import L2_BYTES, LAYERS, SHAPES, STEP, TURNS, card, device_us, host_us, turn  # noqa: E402

BK = BM = 256
PADDED_NS = (4, 20)
COMPACT_NS = (1, 4, 20)


def worker(root: Path, check: bool = True) -> dict:
    """One turn: this checkout's kernels at every point (run in a child)."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.core import ternary
    from repro_torch.kernels import tsar_matmul as tm
    from repro_torch.kernels import tsar_sparse as ts
    from repro_torch.sparse import format as sformat

    if not Path(ts.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {ts.__file__}, not the checkout at {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []
    for k, m in SHAPES:
        t = block_sparse_ternary(torch, rng, k, m, BK, BM, dev)
        w_scale = torch.from_numpy(rng.uniform(0.25, 2.0, m).astype(np.float32)).to(dev)
        full = sformat.pad_from_ternary(t, w_scale, BK, BM)
        live, s_max = int(full.counts.sum()), int(full.counts.max())
        pads = {"padded": sformat.pad_from_ternary(t, w_scale, BK, BM, max_live=live,
                                                   s_steps=s_max),
                "compact": sformat.from_ternary(t, w_scale, BK, BM)}
        kb, mb = full.grid
        wsc = torch.nn.functional.pad(w_scale, (0, mb * BM - m))
        copies = max(2, min(256, math.ceil(2 * L2_BYTES / (live * 2 * (BK // 8) * BM))))
        tw = ternary.pack(t, w_scale)
        dcopies = max(2, min(256, math.ceil(2 * L2_BYTES / (k * m / 4))))
        planes = [(tw.sign_plane.clone(), tw.zero_plane.clone()) for _ in range(dcopies)]
        for kind, ns, fn in (("padded", PADDED_NS, ts.tsar_sparse_padded_matmul_packed),
                             ("compact", COMPACT_NS, ts.tsar_sparse_matmul_packed)):
            p = pads[kind]
            sched = (p.kids, p.slots, p.counts, wsc)
            pools = [(p.sign_pool.clone(), p.zero_pool.clone()) for _ in range(copies)]
            for n in ns:
                a_q = torch.from_numpy(rng.integers(-127, 128, (n, kb * BK), dtype=np.int8)).to(dev)
                a_s = torch.from_numpy(rng.uniform(0.01, 1.0, (n, 1)).astype(np.float32)).to(dev)
                plain = ts.tsar_sparse_padded_plain(a_q, a_s, p.sign_pool, p.zero_pool, *sched)
                for s, z in pools[:2]:
                    if check and not torch.equal(fn(a_q, a_s, s, z, *sched), plain):
                        raise AssertionError(f"{root}: {kind} kernel != plain at N={n} K={k} M={m}")
                calls = [(lambda s=s, z=z: fn(a_q, a_s, s, z, *sched)) for s, z in pools]
                row = {"kind": kind, "n": n, "k": k, "m": m, "live": live,
                       "s_steps": p.kids.shape[1],
                       "device_us": device_us(torch, calls, 2 * copies),
                       "host_us": host_us(torch, calls[0])}
                if kind == "padded":
                    a_k = a_q[:, :k].contiguous()
                    row["dense_us"] = device_us(torch, [
                        (lambda s=s, z=z: tm.tsar_matmul_packed(a_k, a_s, s, z, tw.scale))
                        for s, z in planes], 2 * dcopies)
                rows.append(row)
            del pools
        del planes
    return {"root": str(root), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, nargs="?", help="root of the earlier checkout")
    ap.add_argument("--new", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path,
                    default=Path(__file__).resolve().parents[1] / "build" / "tsar_sparse_ab.json",
                    help="write the results as JSON here")
    ap.add_argument("--time-only", action="store_true",
                    help="time without the torch.equal check (probe trees)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), check=not args.time_only)), flush=True)
        return 0
    if args.old is None:
        ap.error("the earlier checkout's root is needed")
    print(f"card: {card()}", flush=True)
    roots = {"old": args.old.resolve(), "new": args.new.resolve()}
    extra = ("--time-only",) if args.time_only else ()
    turns = [(name, turn(roots[name], __file__, *extra)) for name in TURNS]
    # by_turn[i][(kind, n, k, m)] -> that turn's row; old = turns 0 and 3, new = 1 and 2.
    by_turn = [{(r["kind"], r["n"], r["k"], r["m"]): r for r in t["rows"]} for _, t in turns]
    idx = {v: [i for i, name in enumerate(TURNS) if name == v] for v in ("old", "new")}

    def mean(v: str, key: tuple, field: str = "device_us") -> float:
        return statistics.mean(by_turn[i][key][field] for i in idx[v])

    def dense(key: tuple) -> float:
        return statistics.mean(t[key]["dense_us"] for t in by_turn)

    def bound_us(key: tuple) -> float:
        r = by_turn[0][key]
        kb, mb = -(-r["k"] // BK), -(-r["m"] // BM)
        return sparse_bound(r["n"], kb * BK, BK, BM, mb, r["s_steps"], r["live"])[0] * 1e3

    for kind in ("padded", "compact"):
        print(f"{kind}: N  K x M | device us old new new old | "
              + ("dense tsar_matmul us | new / dense | " if kind == "padded" else "")
              + "wrapper host us old new new old | bound us | new %, old % of bound | old / new")
        for key in sorted(k for k in by_turn[0] if k[0] == kind):
            _, n, k, m = key
            dev = " ".join(f"{t[key]['device_us']:.2f}" for t in by_turn)
            host = " ".join(f"{t[key]['host_us']:.2f}" for t in by_turn)
            b = bound_us(key)
            extra = (f"{dense(key):.2f} | {mean('new', key) / dense(key):.2f} | "
                     if kind == "padded" else "")
            print(f"{kind}: {n:2d} {k}x{m} | {dev} | {extra}{host} | {b:.3f} | "
                  f"{b / mean('new', key):.1%}, {b / mean('old', key):.1%} | "
                  f"{mean('old', key) / mean('new', key):.2f}", flush=True)
    for n in PADDED_NS:
        keys = [("padded", n, k, m) for k, m in STEP]
        o, w = (LAYERS * sum(mean(v, key) for key in keys) / 1e3 for v in ("old", "new"))
        d = LAYERS * sum(dense(key) for key in keys) / 1e3
        b = LAYERS * sum(bound_us(key) for key in keys) / 1e3
        print(f"padded, one step at N={n} (210 calls): old {o:.4f} ms, new {w:.4f} ms, dense "
              f"tsar_matmul {d:.4f} ms (new / dense {w / d:.2f}), bound {b:.4f} ms (new "
              f"{b / w:.1%}, old {b / o:.1%} of bound)", flush=True)
    for n in COMPACT_NS:
        keys = [("compact", n, k, m) for k, m in STEP]
        o, w = (sum(mean(v, key) for key in keys) for v in ("old", "new"))
        b = sum(bound_us(key) for key in keys)
        print(f"compact, one layer at N={n} (7 calls): old {o:.2f} us, new {w:.2f} us, bound "
              f"{b:.2f} us (new {b / w:.1%}, old {b / o:.1%} of bound)", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card(), "turns": turns}, indent=1))
    print(f"card: {card()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
