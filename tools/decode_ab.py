#!/usr/bin/env python3
"""A/B of the serving engine's pure-decode step of two checkouts on one GPU.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/decode_ab.py build/parent [--new .] [--pairs 3] [--out build/decode_ab.json] \
        [--arch bitnet-2b-4t | deepseek-moe-16b]

Each checkout is driven through its own ``repro_torch`` package: a
full-width config (``bitnet-2b-4t`` by default: 30 layers; random weights
from generator seed 0, frozen with ``freeze_params``; an MoE config's layers
are drawn and frozen one at a time, as ``chip_smoke.py`` does, since its
latent tree does not fit) served by ``ServingEngine`` with 4 slots,
``prefill_chunk`` 16, ``block_size`` 16 and ``max_len`` 256 under the
default ``flat`` policy.  Four 8-token prompts are prefilled, then every
slot decodes; a turn measures

* the wall time of 20 pure-decode steps, each synchronized (ms per step:
  median, min, max);
* ``torch.profiler`` over 4 more steps: device time per step (the sum of the
  device rows), aten ops and kernel launches per step.

The checkouts run in alternating pairs (old, new), (new, old), ..., each
turn in a process of its own, so a host that changes speed during the call
moves both.  Needs ``nvcc`` and a GPU; the card's name and power limit are
printed first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tsar_matmul_ab import card, turn  # noqa: E402

WALL_STEPS = 20
PROFILED_STEPS = 4


def worker(root: Path, arch: str) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.configs as configs
    from repro_torch.models import model_zoo, transformer
    from repro_torch.serving import Request, ServingEngine, freeze_params

    cfg = configs.get(arch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.is_moe:
        blocks = [freeze_params(transformer.init_block(cfg, gen, dev))
                  for _ in range(cfg.n_layers)]
        params = {"blocks": transformer.stack_layers(blocks),
                  **transformer.init_head(cfg, gen, dev)}
        del blocks
    else:
        latents = model_zoo.init_params(cfg, gen, dev)
        params = freeze_params(latents)
        del latents
    engine = ServingEngine(cfg, params, max_len=256, batch_slots=4, prefill_chunk=16,
                           device=dev)
    engine.run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32), max_new_tokens=2)])
    for i in range(4):
        engine.submit(Request(uid=i, prompt=np.arange(8, dtype=np.int32) + i,
                              max_new_tokens=64))
    while any(s is None or s.prefilling for s in engine._slots):
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(WALL_STEPS):
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            engine.step()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in avgs
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    ops = sum(e.count for e in avgs if e.key.startswith("aten::"))
    launches = sum(e.count for e in avgs if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                      "cudaLaunchKernelExC"))
    return {"wall_ms": wall, "device_ms": device_us / PROFILED_STEPS / 1e3,
            "aten_ops": ops / PROFILED_STEPS, "launches": launches / PROFILED_STEPS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, nargs="?", help="root of the earlier checkout")
    ap.add_argument("--new", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--pairs", type=int, default=3, help="alternating (old, new) pairs")
    ap.add_argument("--out", type=Path, default=None, help="write the results as JSON here")
    ap.add_argument("--arch", default="bitnet-2b-4t",
                    help="the full-width config served (a dense or MoE one)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.arch)), flush=True)
        return 0
    if args.old is None:
        ap.error("the earlier checkout's root is needed")
    print(f"card: {card()}; {args.arch}", flush=True)
    roots = {"old": args.old.resolve(), "new": args.new.resolve()}
    order = [name for i in range(args.pairs)
             for name in (("old", "new") if i % 2 == 0 else ("new", "old"))]
    turns = []
    print("turn version | decode ms/step median min max | device ms/step | aten ops/step | "
          "launches/step", flush=True)
    for i, name in enumerate(order):
        r = turn(roots[name], __file__, "--arch", args.arch)
        turns.append({"version": name, **r})
        w = r["wall_ms"]
        print(f"{i} {name} | {statistics.median(w):.2f} {min(w):.2f} {max(w):.2f} | "
              f"{r['device_ms']:.3f} | {r['aten_ops']:.0f} | {r['launches']:.0f}", flush=True)
    for name in ("old", "new"):
        mine = [t for t in turns if t["version"] == name]
        print(f"{name}: decode ms/step (median of each turn's median) "
              f"{statistics.median(statistics.median(t['wall_ms']) for t in mine):.2f}, "
              f"device ms/step {statistics.mean(t['device_ms'] for t in mine):.3f}, "
              f"aten ops/step {statistics.mean(t['aten_ops'] for t in mine):.0f}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card(), "arch": args.arch, "turns": turns},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
