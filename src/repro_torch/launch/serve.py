"""Serving driver: packed 2-bit T-SAR weights, batched requests, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-2b-4t \
        --requests 8 --max-new 16

``--smoke`` serves the reduced config; ``--device cpu`` runs the plain
PyTorch path on the CPU.  Weights are random (seed 0): nothing is
downloaded.  ``--sparse`` and ``--sparse-block`` set the freeze's padded
block pools; ``--plan-file`` loads an execution plan (the reference's JSON
format) or saves the compiled one there, ``--save-plan`` also writes it, and
``--print-plan`` prints the per-layer table.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.plan import ModelPlan, format_plan
from repro_torch.serving import Request, ServingEngine, freeze_params

_SPARSE = {"auto": "auto", "true": True, "false": False}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sparse", choices=sorted(_SPARSE), default="auto",
                    help="padded block-sparse pools: where blocks die (auto), "
                         "always (true) or never (false)")
    ap.add_argument("--sparse-block", type=int, nargs="+", default=None,
                    metavar="B", help="pool block shape: BK [BM] (default 256 256)")
    ap.add_argument("--plan-file", default=None, metavar="PATH",
                    help="execution-plan JSON: loaded if it exists, otherwise "
                         "the compiled plan is saved there")
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="also write the engine's plan JSON here after init")
    ap.add_argument("--print-plan", action="store_true",
                    help="print the per-layer, per-bucket plan table")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    block = None
    if args.sparse_block:
        block = (args.sparse_block[0], args.sparse_block[-1])
    # Freeze before the engine so the latent fp32 weights can be dropped.
    params = freeze_params(zoo.init_params(cfg, gen, dev), sparse=_SPARSE[args.sparse],
                           block_shape=block)
    plan = None
    if args.plan_file and os.path.exists(args.plan_file):
        plan = ModelPlan.load(args.plan_file)
        print(f"plan: loaded {args.plan_file} ({len(plan.layers)} layers, "
              f"buckets {list(plan.buckets)})")
    engine = ServingEngine(cfg, params, max_len=args.max_len,
                           batch_slots=args.slots, plan=plan, device=dev)
    if plan is None and args.plan_file:
        engine.plan.save(args.plan_file)
        print(f"plan: compiled and saved to {args.plan_file}")
    if args.save_plan:
        engine.plan.save(args.save_plan)
    s = engine.plan.summary()
    print(f"plan: {s['layers']} layers | decode -> {s['decode_kernel']} | "
          f"prefill -> {s['prefill_kernel']}")
    if args.print_plan:
        print(format_plan(engine.plan))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=4 + i % 8),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    engine.run(reqs)
    for r in reqs[:4]:
        print(f"req {r.uid}: {r.out_tokens}")
    pct = engine.latency_percentiles()
    t, p = pct["ttft_s"], pct["tpot_s"]
    print(f"prefill {engine.stats['prefill_s']:.2f}s | "
          f"decode {engine.stats['decode_s']:.2f}s | "
          f"{engine.throughput():.1f} tok/s steady-state (packed 2-bit, {dev})")
    print(f"TTFT p50/p99 {t['p50'] * 1e3:.0f}/{t['p99'] * 1e3:.0f}ms | "
          f"TPOT p50/p99 {p['p50'] * 1e3:.2f}/{p['p99'] * 1e3:.2f}ms | "
          f"steps {engine.stats['steps']}")
    return engine, reqs


if __name__ == "__main__":
    main()
