#!/usr/bin/env python3
"""A/B of the ``tsar_matmul`` CUDA kernel of two checkouts on one GPU.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/tsar_matmul_ab.py build/parent [--new .] [--out build/tsar_matmul_ab.json]

Each checkout is driven through its own ``repro_torch`` package (the
wrapper ``kernels.tsar_matmul.tsar_matmul_packed`` and ``kernels.ops``), so
any two revisions compare, each building its kernel from its own sources
into its own ``build/``.  They run in turns, old, new, new, old, each turn
in a process of its own, at the eight (N, K, M) shapes of the
``bitnet-2b-4t`` serving step.  Per shape and turn:

* every call's output ``torch.equal`` to the checkout's plain version;
* device us per call: median of 21 CUDA-graph replays cycling over enough
  plane copies to defeat the 50 MB L2 (as ``chip_smoke.py`` times);
* host us per call, of the kernel's wrapper and of ``ops.tsar_matmul``
  (quantization included): the least of 15 loops of 100 eager calls, timed
  on the host clock without synchronizing inside a loop (a shared host only
  adds time, so the least loop is the steadiest estimate).

Then the bytes bound and its share, the sums over one decode step (30
layers x 7 projections) and the N=20 / N=4 ratios.  Needs ``nvcc`` and a
GPU; the card's name and power limit are printed first and last.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPES = ((2560, 640), (2560, 2560), (2560, 6912), (6912, 2560))
# One decode step: wq, wk, wv, wo, w_gate, w_up, w_down x 30 layers.
STEP = ((2560, 2560), (2560, 640), (2560, 640), (2560, 2560), (2560, 6912), (2560, 6912),
        (6912, 2560))
LAYERS = 30
L2_BYTES = 50 * 2**20
HBM_BYTES_PER_S = 3.35e12
TURNS = ("old", "new", "new", "old")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def bound_us(n: int, k: int, m: int) -> float:
    """Bytes over HBM bandwidth (the int8 work is below the ridge at these N)."""
    return (k * m / 4 + n * k + 4 * n + 4 * n * m + 4 * m) / HBM_BYTES_PER_S * 1e6


def device_us(torch, calls: list, per: int, reps: int = 21) -> float:
    """Median us per call over ``reps`` replays of a graph of ``per`` calls."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per * 1e3)
    return statistics.median(times)


def host_us(torch, call, calls: int = 100, reps: int = 15) -> float:
    """Least host us per eager call over ``reps`` loops of ``calls``."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return min(times)


def worker(root: Path) -> dict:
    """One turn: this checkout's kernel at every shape (run in a child)."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.core import ternary
    from repro_torch.kernels import ops
    from repro_torch.kernels import tsar_matmul as tm

    if not Path(tm.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {tm.__file__}, not the checkout at {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for n in (4, 20):
        for k, m in SHAPES:
            a_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
            a_s = torch.rand((n, 1), generator=gen, device=dev) + 0.01
            w_s = torch.rand((m,), generator=gen, device=dev) + 0.01
            copies = max(2, min(256, math.ceil(2 * L2_BYTES / (k * m / 4))))
            planes = [tuple(torch.randint(0, 256, (k // 8, m), generator=gen, device=dev,
                                          dtype=torch.uint8) for _ in range(2))
                      for _ in range(copies)]
            for s, z in planes:
                got = tm.tsar_matmul_packed(a_q, a_s, s, z, w_s)
                if not torch.equal(got, tm.tsar_matmul_plain(a_q, a_s, s, z, w_s)):
                    raise AssertionError(f"{root}: kernel != plain at N={n} K={k} M={m}")
            calls = [(lambda s=s, z=z: tm.tsar_matmul_packed(a_q, a_s, s, z, w_s))
                     for s, z in planes]
            x = torch.randn((n, k), generator=gen, device=dev)
            tw = ternary.pack(torch.randint(-1, 2, (k, m), generator=gen, device=dev)
                              .to(torch.float32), w_s)
            rows.append({"n": n, "k": k, "m": m,
                         "device_us": device_us(torch, calls, 2 * copies),
                         "host_us": host_us(torch, calls[0]),
                         "ops_host_us": host_us(torch, lambda: ops.tsar_matmul(x, tw))})
            del planes, calls
    return {"root": str(root), "rows": rows}


def turn(root: Path, script: str = __file__, *extra: str) -> dict:
    """One turn: ``script --worker root [extra...]`` in a process of its own."""
    res = subprocess.run([sys.executable, script, "--worker", str(root), *extra],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"turn in {root} failed:\n{res.stdout[-4000:]}{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, nargs="?", help="root of the earlier checkout")
    ap.add_argument("--new", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--out", type=Path, default=None, help="write the results as JSON here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    if args.old is None:
        ap.error("the earlier checkout's root is needed")
    print(f"card: {card()}", flush=True)
    roots = {"old": args.old.resolve(), "new": args.new.resolve()}
    turns = [(name, turn(roots[name])) for name in TURNS]
    # by_turn[i][(n, k, m)] -> that turn's row; old = turns 0 and 3, new = 1 and 2.
    by_turn = [{(r["n"], r["k"], r["m"]): r for r in t["rows"]} for _, t in turns]
    idx = {v: [i for i, name in enumerate(TURNS) if name == v] for v in ("old", "new")}

    def mean(v: str, shape: tuple, field: str = "device_us") -> float:
        return statistics.mean(by_turn[i][shape][field] for i in idx[v])

    print("N  K x M | device us old new new old | wrapper host us old new new old | "
          "ops.tsar_matmul host us old new | bound us | new %, old % of bound")
    for shape in by_turn[0]:
        n, k, m = shape
        dev = " ".join(f"{t[shape]['device_us']:.2f}" for t in by_turn)
        host = " ".join(f"{t[shape]['host_us']:.2f}" for t in by_turn)
        b = bound_us(n, k, m)
        print(f"{n:2d} {k}x{m} | {dev} | {host} | {mean('old', shape, 'ops_host_us'):.2f} "
              f"{mean('new', shape, 'ops_host_us'):.2f} | {b:.3f} | "
              f"{b / mean('new', shape):.1%}, {b / mean('old', shape):.1%}", flush=True)
    for n in (4, 20):
        o, w = (LAYERS * sum(mean(v, (n, k, m)) for k, m in STEP) / 1e3 for v in ("old", "new"))
        b = LAYERS * sum(bound_us(n, k, m) for k, m in STEP) / 1e3
        print(f"one step at N={n}: old {o:.4f} ms, new {w:.4f} ms, bound {b:.4f} ms "
              f"(new {b / w:.1%}, old {b / o:.1%} of bound)", flush=True)
    for k, m in SHAPES:
        r = {v: mean(v, (20, k, m)) / mean(v, (4, k, m)) for v in ("old", "new")}
        print(f"N=20/N=4 at {k}x{m}: new {r['new']:.2f}, old {r['old']:.2f}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card(), "turns": turns}, indent=1))
    print(f"card: {card()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
