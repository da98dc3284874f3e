"""Serving driver: packed 2-bit T-SAR weights, batched requests, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-2b-4t \
        --requests 8 --max-new 16

``--arch`` takes any config of every family (``bitnet-2b-4t``,
``deepseek-moe-16b``, ``mamba2-780m``, ``hymba-1.5b``, ``whisper-tiny``,
``llava-next-mistral-7b``, ...; the SSM, hybrid, enc-dec and VLM ones run
the ``whole`` policy, the enc-dec encoder on zero frames and the VLM on
zero patches, the reference's stubs).  ``--max-len`` defaults to 128 plus
a VLM's ``frontend_seq`` patch positions.  ``--smoke`` serves the reduced
config; ``--device cpu`` runs the plain PyTorch path on the CPU.  Weights
are random (seed 0): nothing is downloaded.  ``--sparse`` and ``--sparse-block`` set the freeze's padded
block pools; ``--plan-file`` loads an execution plan (the reference's JSON
format) or saves the compiled one there, ``--save-plan`` also writes it,
``--print-plan`` prints the per-layer table, and ``--prefix-cache
[CAPACITY_BLOCKS]`` turns on prefix-caching KV reuse (the value caps the
cached blocks).  ``--no-packed`` serves the latent weights as they are
(QAT serving: the exact int8 pipeline, no freeze, no plan, no kernel).
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
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache positions per slot (default 128, plus a VLM's patches)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-packed", action="store_true",
                    help="serve the latent weights: no freeze, no plan, no kernel")
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
    ap.add_argument("--prefix-cache", nargs="?", const=True, default=False,
                    type=int, metavar="CAPACITY_BLOCKS",
                    help="enable prefix-caching KV reuse; optional value "
                         "caps the cached-block footprint (LRU-evicted)")
    args = ap.parse_args(argv)
    if args.no_packed and (args.plan_file or args.save_plan or args.print_plan):
        ap.error("--no-packed serves without an execution plan")

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    block = None
    if args.sparse_block:
        block = (args.sparse_block[0], args.sparse_block[-1])
    params = zoo.init_params(cfg, gen, dev)
    if not args.no_packed:
        # Freeze before the engine so the latent fp32 weights can be dropped.
        params = freeze_params(params, sparse=_SPARSE[args.sparse], block_shape=block)
    plan = None
    if args.plan_file and os.path.exists(args.plan_file):
        plan = ModelPlan.load(args.plan_file)
        print(f"plan: loaded {args.plan_file} ({len(plan.layers)} layers, "
              f"buckets {list(plan.buckets)})")
    max_len = args.max_len or 128 + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    engine = ServingEngine(cfg, params, max_len=max_len,
                           batch_slots=args.slots, plan=plan, packed=not args.no_packed,
                           prefix_cache=args.prefix_cache, device=dev)
    if plan is None and args.plan_file:
        engine.plan.save(args.plan_file)
        print(f"plan: compiled and saved to {args.plan_file}")
    if args.save_plan:
        engine.plan.save(args.save_plan)
    if engine.plan is not None:
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
          f"{engine.throughput():.1f} tok/s steady-state "
          f"({'latent' if args.no_packed else 'packed 2-bit'}, {dev})")
    print(f"TTFT p50/p99 {t['p50'] * 1e3:.0f}/{t['p99'] * 1e3:.0f}ms | "
          f"TPOT p50/p99 {p['p50'] * 1e3:.2f}/{p['p99'] * 1e3:.2f}ms | "
          f"steps {engine.stats['steps']}")
    if engine.prefix is not None:
        print(f"prefix cache: hit rate {engine.stats['prefix_hit_rate']:.2f} | "
              f"{engine.stats['cached_blocks']} cached blocks | "
              f"{engine.stats['prefix_evictions']} evictions")
    return engine, reqs


if __name__ == "__main__":
    main()
