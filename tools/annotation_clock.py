#!/usr/bin/env python3
"""Which kernels does an annotated engine step own in a ``torch.profiler``
trace?  Three ways of crediting them, side by side, on one GPU.

    python3 tools/annotation_clock.py [--reps 3]

Full-width ``bitnet-2b-4t``, the engine of ``chip_smoke.py``'s annotation
phase (4 slots busy, pure decode, ``profiler_annotations=True``), 4 steps
profiled after a 1-step schedule warm-up, repeated ``--reps`` times.  For
each ``tsar_engine_step#<n>`` range it counts the ``tsar_matmul`` kernels
(210 per step) credited to it

* by timestamp: the kernel's device start lies inside the range's host
  interval;
* by device span: the kernel's start lies inside the range's own device
  span (the profiler's device-side copy of the annotation);
* by launch: the runtime call with the kernel's correlation id
  (``cudaLaunchKernel``, ...) starts inside the range's host interval;

and prints the host interval beside the device span, so the drift of the
device clock against the host's shows.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("annotation_clock: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke as cs
    import repro_torch.configs as configs
    from repro_torch.kernels import _build
    from repro_torch.obs import trace
    from repro_torch.serving import Request

    print(cs.gpu_line(), f"| torch {torch.__version__}", flush=True)
    _build.build(cs.KERNEL_SOURCES)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(cs.ARCH)
    params = cs.init_frozen(torch, cfg)
    cuda = torch.autograd.DeviceType.CUDA
    bad = 0
    for rep in range(args.reps):
        engine = cs.dense_engine(torch, cfg, params, profiler_annotations=True)
        for i in range(4):
            engine.submit(Request(uid=i, prompt=np.arange(8, dtype=np.int32) + i,
                                  max_new_tokens=32))
        while any(s is None or s.prefilling for s in engine._slots):
            engine.step()
        engine.step()
        torch.cuda.synchronize()
        held = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=4, repeat=1),
                     on_trace_ready=lambda p: held.setdefault("events", list(p.events()))
                     ) as prof:
            for _ in range(5):
                engine.step()
                prof.step()
        host = [e for e in held["events"] if e.device_type != cuda]
        dev = [e for e in held["events"] if e.device_type == cuda]
        ranges = sorted((e for e in host if e.name.startswith(trace.STEP_RANGE + "#")),
                        key=lambda e: e.time_range.start)
        kernels = [e for e in dev if "tsar_matmul_kernel" in e.name]
        runtime = {e.id: e for e in host if e.name.startswith("cu")}
        for r in ranges:
            lo, hi = r.time_range.start, r.time_range.end
            span = next(e.time_range for e in dev if e.name == r.name)
            by_time = sum(lo <= e.time_range.start < hi for e in kernels)
            by_span = sum(span.start <= e.time_range.start <= span.end for e in kernels)
            by_launch = sum(e.id in runtime and lo <= runtime[e.id].time_range.start < hi
                            for e in kernels)
            bad += by_launch != 7 * cfg.n_layers
            print(f"rep {rep} {r.name}: timestamp {by_time}, device span {by_span}, "
                  f"launch {by_launch} | host [{lo:.1f}, {hi:.1f}] us, device span "
                  f"[{span.start:.1f}, {span.end:.1f}] us: end {span.end - hi:+.1f} us "
                  "past the host's", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
