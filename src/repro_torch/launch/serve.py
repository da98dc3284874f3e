"""Serving driver: packed 2-bit T-SAR weights, batched requests, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch bitnet-2b-4t \
        --requests 8 --max-new 16

``--smoke`` serves the reduced config; ``--device cpu`` runs the plain
PyTorch path on the CPU.  Weights are random (seed 0): nothing is
downloaded.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.serving import Request, ServingEngine, freeze_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    # Freeze before the engine so the latent fp32 weights can be dropped.
    params = freeze_params(zoo.init_params(cfg, gen, dev))
    engine = ServingEngine(cfg, params, max_len=args.max_len,
                           batch_slots=args.slots, device=dev)
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
