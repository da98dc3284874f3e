#!/usr/bin/env python3
"""A/B of the serving engine at bitnet-2b-4t's whole 4096-token context, two
checkouts on one GPU.

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 tools/long_context_ab.py build/parent [--new .] [--pairs 2] \
        [--policy flat | chunked | whole] [--out build/long_context_ab.json]

Each checkout is driven through its own ``repro_torch`` package:
full-width ``bitnet-2b-4t`` (30 layers; random weights from generator seed
0, frozen with ``freeze_params``) served by ``ServingEngine`` as
``chip_smoke.py`` phase 8c serves it: ``max_len`` 4096, 4 slots, block 16,
prefill chunk 512 (516 tokens per flat step), prompts of 4064, 4064, 2048
and 256 tokens (numpy seed 0) with 16 new tokens each, after ``warmup``.
A turn reports the engine's ms per prefill call and per pure-decode step
(host clock around each synchronized step), the run's wall seconds, the
card's ``max_memory_allocated`` over the run and a digest of the greedy
tokens (equal digests: equal tokens).

The checkouts run in alternating pairs (old, new), (new, old), ..., each
turn in a process of its own, so a host that changes speed during the call
moves both.  Needs ``nvcc`` and a GPU; the card's name and power limit are
printed first.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tsar_matmul_ab import card, turn  # noqa: E402

MAX_LEN, SLOTS, CHUNK = 4096, 4, 512
PROMPTS, NEW = (4064, 4064, 2048, 256), 16


def worker(root: Path, policy: str) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    import repro_torch.configs as configs
    from repro_torch.models import model_zoo
    from repro_torch.serving import Request, ServingEngine, freeze_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("bitnet-2b-4t")
    dev = torch.device("cuda")
    latents = model_zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = freeze_params(latents)
    del latents
    engine = ServingEngine(cfg, params, max_len=MAX_LEN, batch_slots=SLOTS,
                           prefill_chunk=CHUNK, block_size=16, policy=policy, device=dev)
    engine.warmup(seq_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32),
                    max_new_tokens=NEW) for i, n in enumerate(PROMPTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(r.done and len(r.out_tokens) == NEW for r in reqs)
    decode = engine.metrics.get("decode_steps").value
    prefill = engine.metrics.get("prefill_steps").value + engine.stats["whole_prefills"]
    tokens = [r.out_tokens for r in reqs]
    return {"prefill_ms": engine.stats["prefill_s"] / max(1, prefill) * 1e3,
            "decode_ms": engine.stats["decode_s"] / max(1, decode) * 1e3,
            "steps": engine.stats["steps"], "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "tokens": hashlib.sha256(repr(tokens).encode()).hexdigest()[:16]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, nargs="?", help="root of the earlier checkout")
    ap.add_argument("--new", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--pairs", type=int, default=2, help="alternating (old, new) pairs")
    ap.add_argument("--policy", default="flat", choices=("flat", "chunked", "whole"))
    ap.add_argument("--out", type=Path, default=None, help="write the results as JSON here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve(), args.policy)), flush=True)
        return 0
    if args.old is None:
        ap.error("the earlier checkout's root is needed")
    print(f"card: {card()}; bitnet-2b-4t, max_len {MAX_LEN}, {SLOTS} slots, chunk {CHUNK}, "
          f"prompts {list(PROMPTS)}, {NEW} new tokens, {args.policy}", flush=True)
    roots = {"old": args.old.resolve(), "new": args.new.resolve()}
    order = [name for i in range(args.pairs)
             for name in (("old", "new") if i % 2 == 0 else ("new", "old"))]
    turns = []
    print("turn version | prefill ms/call | decode ms/step | steps | wall s | peak GiB | "
          "tokens", flush=True)
    for i, name in enumerate(order):
        r = turn(roots[name], __file__, "--policy", args.policy)
        turns.append({"version": name, **r})
        print(f"{i} {name} | {r['prefill_ms']:.2f} | {r['decode_ms']:.2f} | {r['steps']} | "
              f"{r['wall_s']:.2f} | {r['peak_gib']:.2f} | {r['tokens']}", flush=True)
    for name in ("old", "new"):
        mine = [t for t in turns if t["version"] == name]
        print(f"{name}: prefill ms/call {statistics.mean(t['prefill_ms'] for t in mine):.2f}, "
              f"decode ms/step {statistics.mean(t['decode_ms'] for t in mine):.2f}, peak "
              f"{max(t['peak_gib'] for t in mine):.2f} GiB", flush=True)
    print(f"tokens {'equal' if len({t['tokens'] for t in turns}) == 1 else 'DIFFER'} "
          "across the turns", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card(), "policy": args.policy,
                                        "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
