"""End-to-end serving on the PyTorch port (the paper's inference scenario;
the counterpart of ``examples/serve_ternary.py``): batched requests against
a ternary LM with packed 2-bit weights, token-budgeted continuous batching
over a block-paged KV cache.

Prints per-request latency percentiles (registry histograms) alongside
throughput:
  * TTFT: time to first token (admission + prefill latency),
  * TPOT: mean time per output token after the first (decode cadence),
plus the engine's step-budget telemetry showing that no step ran more than
``prefill_chunk + slots`` real tokens (no whole-prompt stall).

    PYTHONPATH=src python examples/torch_serve_ternary.py [--arch gemma2-2b] \\
        [--requests 8] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.plan import format_plan
from repro_torch.serving import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bitnet-2b-4t")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--policy", choices=["chunked", "whole"], default=None,
                    help="default: the engine's own (flat where the family supports it)")
    ap.add_argument("--no-packed", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable prefix-caching KV reuse (shared system "
                         "prompts fork cached blocks instead of re-prefilling)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend an N-token shared system prompt to every "
                         "request (demonstrates prefix-cache hits)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get(args.arch).reduced()
    params = zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    # Mixed prompt lengths: short chats next to prompts spanning many chunks.
    rng = np.random.default_rng(0)
    lens = [6 + i % 5 if i % 3 else 3 * args.prefill_chunk + i for i in range(args.requests)]
    # max_len tracks the workload so large --prefill-chunk values don't push
    # the long prompts past the admission limit (finished-ignored).
    max_len = max(128, max(lens, default=0) + args.shared_prefix + args.max_new + 1)
    engine = ServingEngine(cfg, params, max_len=max_len, batch_slots=args.slots,
                           packed=not args.no_packed,
                           prefill_chunk=args.prefill_chunk, policy=args.policy,
                           prefix_cache=args.prefix_cache, device=dev)
    if engine.plan is not None:
        # Compile-once kernel plan (paper Sec. III-D / Fig. 5): the engine
        # costed every registered kernel per layer per n-bucket at init;
        # the steps below just execute this table.
        print("execution plan (compiled once at engine init):")
        print(format_plan(engine.plan, max_rows=12))
    if engine.density is not None:
        print(f"weight density (measured): mean {engine.density['density_mean']:.3f} "
              f"min {engine.density['density_min']:.3f} | "
              f"live-block fraction {engine.density['block_density_mean']:.3f} "
              f"over {engine.density['layers']} BitLinear layers "
              f"(tsar_sparse break-even ~0.9; see docs/kernels.md)")
    sys_prompt = rng.integers(0, cfg.vocab_size, size=args.shared_prefix)
    reqs = [Request(uid=i,
                    prompt=np.concatenate(
                        [sys_prompt,
                         rng.integers(0, cfg.vocab_size, size=lens[i])]),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    engine.run(reqs)
    wall = time.perf_counter() - t0

    total_new = sum(len(r.out_tokens) for r in reqs)
    span = f"prompts {min(lens)}..{max(lens)} tok, " if lens else ""
    print(f"\n{args.requests} requests ({span}policy={engine.policy}), "
          f"{total_new} tokens in {wall:.2f}s")
    print(f"prefill time {engine.stats['prefill_s']:.2f}s | "
          f"decode time {engine.stats['decode_s']:.2f}s | "
          f"steady-state decode {engine.throughput():.1f} tok/s")
    # Percentiles come straight off the engine's metrics registry (real
    # histograms, repro_torch.obs.metrics): no external replay needed.
    pct = engine.latency_percentiles()
    ttft, tpot = pct["ttft_s"], pct["tpot_s"]
    print(f"TTFT p50 {ttft['p50'] * 1e3:.0f}ms p99 {ttft['p99'] * 1e3:.0f}ms "
          f"max {ttft['max'] * 1e3:.0f}ms | "
          f"TPOT p50 {tpot['p50'] * 1e3:.0f}ms p99 {tpot['p99'] * 1e3:.0f}ms")
    print(f"max step load {engine.max_step_tokens()} real tokens "
          f"(budget {args.prefill_chunk} + {args.slots} slots) | "
          f"whole prefills {engine.stats['whole_prefills']} | "
          f"peak KV blocks {engine.stats['peak_kv_blocks']}/{engine.kv.num_blocks - 1}")
    if engine.prefix is not None:
        print(f"prefix cache: hit rate {engine.stats['prefix_hit_rate']:.2f} "
              f"({engine.stats['prefix_hit_tokens']} prompt tokens reused) | "
              f"{engine.stats['cached_blocks']} cached blocks | "
              f"{engine.stats['prefix_evictions']} evictions")
    return {"requests": reqs, "engine": engine,
            "budget": args.prefill_chunk + args.slots}


if __name__ == "__main__":
    main()
