#!/usr/bin/env python3
"""A/B of the ``tsar_lut`` CUDA kernel of two checkouts on one GPU.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/tsar_lut_ab.py build/parent [--new .] [--out build/tsar_lut_ab.json]

Each checkout is driven through its own ``repro_torch`` package (the
wrapper ``kernels.tsar_lut.tsar_lut_gemv`` and ``kernels.ops``), so any two
revisions compare, each building its kernel from its own sources into its
own ``build/``.  They run in turns, old, new, new, old, each turn in a
process of its own, at the four ``bitnet-2b-4t`` projection shapes x N in
{1, 4, 20}, c = 4.  Per shape and turn:

* every call's output within rtol 1e-4 / atol 2e-3 of the checkout's plain
  version;
* device us per call: median of 21 CUDA-graph replays cycling over enough
  index copies to defeat the 50 MB L2 (as ``chip_smoke.py`` times), and the
  same for one float32 ``torch.matmul`` (TF32 off) on the decoded matrix;
* host us per call, of the kernel's wrapper and of ``ops.tsar_lut_gemv``:
  the least of 15 loops of 100 eager calls.

Then the bound (``chip_smoke.lut_bound``) and its share, and the per-layer
sums (the 7 projections) at each N.  The timing helpers are
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
from chip_smoke import lut_bound  # noqa: E402
from tsar_matmul_ab import L2_BYTES, SHAPES, STEP, TURNS, card, device_us, host_us, turn  # noqa: E402

C = 4
NS = (1, 4, 20)


def worker(root: Path) -> dict:
    """One turn: this checkout's kernel at every shape (run in a child)."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.core import ternary
    from repro_torch.kernels import ops
    from repro_torch.kernels import tsar_lut as tl

    if not Path(tl.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {tl.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = []
    for k, m in SHAPES:
        t = torch.from_numpy(rng.integers(-1, 2, size=(k, m), dtype=np.int8)).to(dev)
        w_s = torch.from_numpy(rng.uniform(0.25, 2.0, m).astype(np.float32)).to(dev)
        ip, iz = ternary.pack_indices(t, C)
        copies = max(2, min(256, math.ceil(2 * L2_BYTES / (2 * ip.numel()))))
        idx = [(ip.clone(), iz.clone()) for _ in range(copies)]
        w = t.to(torch.float32) * w_s
        lib_copies = max(2, min(64, math.ceil(2 * L2_BYTES / (4 * k * m))))
        wl = [w.clone() for _ in range(lib_copies)]
        for n in NS:
            x = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)).to(dev)
            plain = tl.tsar_lut_plain(x, ip, iz, w_s, C)
            for p, z in idx[:2]:
                got = tl.tsar_lut_gemv(x, p, z, w_s, c=C)
                if not torch.allclose(got, plain, rtol=1e-4, atol=2e-3):
                    raise AssertionError(f"{root}: kernel != plain at N={n} K={k} M={m}")
            calls = [(lambda p=p, z=z: tl.tsar_lut_gemv(x, p, z, w_s, c=C)) for p, z in idx]
            rows.append({"n": n, "k": k, "m": m,
                         "device_us": device_us(torch, calls, 2 * copies),
                         "matmul_us": device_us(torch, [(lambda w=w: torch.matmul(x, w))
                                                        for w in wl], 2 * lib_copies),
                         "host_us": host_us(torch, calls[0]),
                         "ops_host_us": host_us(torch, lambda: ops.tsar_lut_gemv(
                             x, ip, iz, w_s, c=C))})
        del idx, wl
    return {"root": str(root), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, nargs="?", help="root of the earlier checkout")
    ap.add_argument("--new", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path,
                    default=Path(__file__).resolve().parents[1] / "build" / "tsar_lut_ab.json",
                    help="write the results as JSON here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    if args.old is None:
        ap.error("the earlier checkout's root is needed")
    print(f"card: {card()}", flush=True)
    roots = {"old": args.old.resolve(), "new": args.new.resolve()}
    turns = [(name, turn(roots[name], __file__)) for name in TURNS]
    # by_turn[i][(n, k, m)] -> that turn's row; old = turns 0 and 3, new = 1 and 2.
    by_turn = [{(r["n"], r["k"], r["m"]): r for r in t["rows"]} for _, t in turns]
    idx = {v: [i for i, name in enumerate(TURNS) if name == v] for v in ("old", "new")}

    def mean(v: str, shape: tuple, field: str = "device_us") -> float:
        return statistics.mean(by_turn[i][shape][field] for i in idx[v])

    def matmul(shape: tuple) -> float:
        return statistics.mean(t[shape]["matmul_us"] for t in by_turn)

    print("N  K x M | device us old new new old | f32 matmul us | new / matmul | "
          "wrapper host us old new new old | ops host us old new | bound us (by) | "
          "new %, old % of bound | old / new")
    for shape in sorted(by_turn[0]):
        n, k, m = shape
        dev = " ".join(f"{t[shape]['device_us']:.2f}" for t in by_turn)
        host = " ".join(f"{t[shape]['host_us']:.2f}" for t in by_turn)
        b_ms, b_by = lut_bound(n, k, m, C)
        b = b_ms * 1e3
        print(f"{n:2d} {k}x{m} | {dev} | {matmul(shape):.2f} | "
              f"{mean('new', shape) / matmul(shape):.2f} | {host} | "
              f"{mean('old', shape, 'ops_host_us'):.2f} {mean('new', shape, 'ops_host_us'):.2f} | "
              f"{b:.3f} ({b_by}) | {b / mean('new', shape):.1%}, {b / mean('old', shape):.1%} | "
              f"{mean('old', shape) / mean('new', shape):.2f}", flush=True)
    for n in NS:
        o, w = (sum(mean(v, (n, k, m)) for k, m in STEP) for v in ("old", "new"))
        mm = sum(matmul((n, k, m)) for k, m in STEP)
        b = sum(lut_bound(n, k, m, C)[0] for k, m in STEP) * 1e3
        print(f"one layer (7 projections) at N={n}: old {o:.2f} us, new {w:.2f} us, f32 "
              f"matmul {mm:.2f} us (new / matmul {w / mm:.2f}), bound {b:.2f} us "
              f"(new {b / w:.1%}, old {b / o:.1%} of bound)", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card(), "turns": turns}, indent=1))
    print(f"card: {card()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
