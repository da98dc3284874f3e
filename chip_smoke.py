#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase; needs one CUDA GPU
    python3 chip_smoke.py --profile  # + torch.profiler over 4 decode steps

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernel from ``src/repro_torch/csrc`` and print the build
   time and ``nvcc``'s register report;
3. kernel phase: ``tsar_matmul`` against its plain PyTorch version at the
   eight (N, K, M) shapes of the ``bitnet-2b-4t`` serving step and at ragged
   shapes, required ``torch.equal``; CUDA-event times (median of 21 CUDA-graph
   replays, each cycling over enough weight copies to defeat the 50 MB L2)
   beside the bytes bound and ``torch._int_mm`` on pre-decoded int8 weights;
4. engine phase: full-width ``bitnet-2b-4t`` (30 layers, random weights from
   seed 0) frozen to 2-bit planes and served through
   ``repro_torch.serving.ServingEngine(device="cuda")``: 8 requests must
   finish, every logit be finite and every token lie in ``[0, vocab)``, and
   the kernel's launch count equal 210 x steps; a real ``w_gate`` projection
   at N=20 must equal its plain version; a reduced-config step on the GPU
   must agree with the same step on the CPU within 1e-4.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package ``repro``.
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

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8
# tensor-core ops/s.  A card set below 700 W runs below them.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

ARCH = "bitnet-2b-4t"
L2_BYTES = 50 * 2**20
REPLAYS = 21


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_graph(torch, calls: list, launches_per_replay: int) -> float:
    """Median ms per call over ``REPLAYS`` replays of one CUDA graph that
    runs ``launches_per_replay`` calls cycling through ``calls``."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches_per_replay):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches_per_replay)
    return statistics.median(times)


def time_eager(torch, call, reps: int = 5) -> float:
    """Median ms per call of an eager function (CUDA events)."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n: int, k: int, m: int) -> tuple[float, str]:
    """Least time (ms) for one call: the larger of the bytes it must move
    (planes K*M/4, int8 activations N*K, f32 a_scale 4N, f32 output 4*N*M,
    f32 w_scale 4M) over HBM bandwidth and its int8 ops 2*N*K*M over the
    int8 tensor-core peak."""
    nbytes = k * m / 4 + n * k + 4 * n + 4 * n * m + 4 * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * k * m / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_shapes(cfg) -> list[tuple[str, int, int]]:
    d, f = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return [("wq", d, qd), ("wk", d, kvd), ("wv", d, kvd), ("wo", qd, d),
            ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]


def kernel_phase(torch, cfg) -> dict:
    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tsar_matmul as tm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    max_err = 0.0
    distinct = sorted({(k, m) for _, k, m in step_shapes(cfg)})
    for n in (4, 20):
        for k, m in distinct:
            a_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                                dtype=torch.int8)
            a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
            w_scale = torch.rand((m,), generator=gen, device=dev) + 0.01
            copies = max(2, min(256, math.ceil(2 * L2_BYTES / (k * m / 4))))
            planes = [(torch.randint(0, 256, (k // 8, m), generator=gen, device=dev,
                                     dtype=torch.uint8),
                       torch.randint(0, 256, (k // 8, m), generator=gen, device=dev,
                                     dtype=torch.uint8)) for _ in range(copies)]
            s0, z0 = planes[0]
            got = tm.tsar_matmul_packed(a_q, a_scale, s0, z0, w_scale)
            want = tm.tsar_matmul_plain(a_q, a_scale, s0, z0, w_scale)
            err = (got - want).abs().max().item()
            _require(torch.equal(got, want),
                     f"tsar_matmul != plain at N={n} K={k} M={m} (max err {err})")
            max_err = max(max_err, err)
            ms = time_graph(torch, [
                (lambda s=s, z=z: tm.tsar_matmul_packed(a_q, a_scale, s, z, w_scale))
                for s, z in planes], launches_per_replay=2 * copies)
            plain_ms = time_eager(
                torch, lambda: tm.tsar_matmul_plain(a_q, a_scale, s0, z0, w_scale))
            # Library yardstick: torch._int_mm on int8 weights decoded ahead
            # of time (4x the weight bytes of the planes), rows padded to 32.
            a32 = torch.zeros((32, k), dtype=torch.int8, device=dev)
            a32[:n] = a_q
            lib_copies = max(2, min(64, math.ceil(2 * L2_BYTES / (k * m))))
            w8 = [ternary.decode_planes(s, z, k).contiguous()
                  for s, z in planes[:lib_copies]]
            library_ms = time_graph(torch, [
                (lambda w=w: torch._int_mm(a32, w)) for w in w8],
                launches_per_replay=2 * lib_copies)
            b_ms, b_by = bound(n, k, m)
            rows[(n, k, m)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": library_ms}
            print(f"tsar_matmul N={n:2d} K={k} M={m}: equal | {ms * 1e3:.2f} us "
                  f"(bound {b_ms * 1e3:.2f} us, {b_by}; {b_ms / ms:.1%} of bound) | "
                  f"plain {plain_ms * 1e3:.1f} us | _int_mm int8 {library_ms * 1e3:.2f} us",
                  flush=True)
            del planes, w8
    # Ragged shapes go through the public wrapper (pads M to a multiple of 4).
    for n in (1, 33):
        k, m = 200, 130
        x = torch.randn((n, k), generator=gen, device=dev)
        t = torch.randint(-1, 2, (k, m), generator=gen, device=dev).to(torch.float32)
        tw = ternary.pack(t, torch.rand((m,), generator=gen, device=dev) + 0.01)
        got = ops.tsar_matmul(x, tw)
        want = ref.quantized_matmul_ref(x, tw)
        _require(got.shape == (n, m), f"ragged output shape {tuple(got.shape)}")
        _require(torch.equal(got, want), f"tsar_matmul != plain at ragged N={n}")
        print(f"tsar_matmul ragged N={n} K={k} M={m}: equal", flush=True)
    return {"rows": rows, "max_abs_err": max_err}


def engine_phase(torch, cfg, profile: bool = False) -> dict:
    import numpy as np

    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tsar_matmul as tm
    from repro_torch.models import model_zoo, transformer
    from repro_torch.serving import Request, ServingEngine, freeze_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    latents = model_zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = freeze_params(latents)
    torch.cuda.synchronize()
    t_freeze = time.perf_counter() - t0
    del latents
    torch.cuda.empty_cache()
    print(f"engine: init {t_init:.2f} s, freeze {t_freeze:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident after freeze",
          flush=True)

    def make_engine():
        return ServingEngine(cfg, params, max_len=256, batch_slots=4,
                             prefill_chunk=16, device=dev)

    make_engine().run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                               max_new_tokens=2)])          # warm-up, not measured

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                size=int(rng.integers(16, 129)),
                                                dtype=np.int32),
                    max_new_tokens=16) for i in range(8)]
    engine = make_engine()
    sample = engine._sample
    checked = []

    def checked_sample(logits, temps):
        checked.append(bool(torch.isfinite(logits).all().item()))
        return sample(logits, temps)

    engine._sample = checked_sample
    tm.LAUNCHES["tsar_matmul"] = 0
    t0 = time.perf_counter()
    engine.run(reqs)
    wall = time.perf_counter() - t0
    launches = tm.LAUNCHES["tsar_matmul"]
    steps = engine.stats["steps"]
    per_step = 7 * cfg.n_layers

    _require(all(r.done and len(r.out_tokens) == 16 for r in reqs),
             "not every request finished with 16 tokens")
    _require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
             "a token outside [0, vocab)")
    _require(checked and all(checked), "non-finite logits in a step")
    _require(launches == per_step * steps,
             f"tsar_matmul launched {launches} times, expected {per_step} x {steps}")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    pct = engine.latency_percentiles()
    print(f"engine: {len(reqs)} requests, {steps} steps "
          f"({engine.metrics.get('prefill_steps').value} with prefill), "
          f"{engine.stats['prefill_tokens']} prompt tokens, {n_tok} generated, "
          f"wall {wall:.3f} s, {n_tok / wall:.1f} generated tok/s | "
          f"decode {engine.throughput():.1f} tok/s over "
          f"{engine.metrics.get('decode_steps').value} pure-decode steps "
          f"({engine.stats['decode_s'] / max(1, engine.metrics.get('decode_steps').value) * 1e3:.2f} ms/step) | "
          f"prefill steps {engine.stats['prefill_s'] / max(1, engine.metrics.get('prefill_steps').value) * 1e3:.2f} ms/step | "
          f"TTFT p50 {pct['ttft_s']['p50'] * 1e3:.1f} ms, TPOT p50 {pct['tpot_s']['p50'] * 1e3:.2f} ms | "
          f"tsar_matmul launches {launches} = {per_step} x {steps}", flush=True)

    # One real full-width projection (layer 0's w_gate) at N=20.
    p = transformer.layer_slice(params["blocks"], 0)["mlp"]["w_gate"]
    tw = ternary.TernaryWeights(p["sign"], p["zero"], p["scale"],
                                (cfg.d_model, cfg.d_ff))
    x = torch.randn((20, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    got, want = ops.tsar_matmul(x, tw), ref.quantized_matmul_ref(x, tw)
    _require(torch.equal(got, want), "w_gate projection != plain version")
    print("engine: layer-0 w_gate at N=20 equal to its plain version", flush=True)
    if profile:
        profile_decode(torch, cfg, make_engine, Request)
    return {"launches": launches}


def profile_decode(torch, cfg, make_engine, request_cls) -> None:
    """torch.profiler over 4 pure-decode steps (4 slots busy): device busy
    share of the wall time and the top ops by device time.  The full table
    goes to chiprun_out/profile_decode.txt."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    engine = make_engine()
    for i in range(4):
        engine.submit(request_cls(uid=i, prompt=np.arange(8, dtype=np.int32) + i,
                                  max_new_tokens=32))
    while any(s is None or s.prefilling for s in engine._slots):
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        engine.step()
    wall_us = (time.perf_counter() - t0) * 1e6 / 4       # profiler off
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            engine.step()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    # Device-side rows only (kernels, memsets, copies); an aten op's own row
    # repeats the device time of the kernels it launched.
    dev_rows = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev_rows) / 4
    table = avgs.table(sort_by="self_device_time_total", row_limit=40)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_decode.txt").write_text(table)
    # The profiler slows the host many times over, so the wall time is taken
    # over 4 other steps with it off: the idle share divides device time
    # measured with the profiler on by wall time measured with it off.
    print(f"profile: decode step {wall_us / 1e3:.2f} ms wall (profiler off), device busy "
          f"{dev_us / 1e3:.2f} ms/step (profiler on) -> idle share "
          f"{1 - dev_us / wall_us:.1%} (mixes the two)", flush=True)
    for e in sorted(dev_rows, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"  {e.key[:60]:60s} {e.count / 4:7.1f}/step "
              f"{e.self_device_time_total / 4e3:8.3f} ms/step", flush=True)
    n_ops = sum(e.count for e in avgs if e.key.startswith("aten::"))
    n_launch = sum(e.count for e in avgs if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    print(f"  per step: {n_ops / 4:.0f} aten ops dispatched (nested included), "
          f"{n_launch / 4:.0f} kernel launches", flush=True)


def cpu_agreement(torch, cfg_full) -> None:
    """Reduced config: one flat step on the GPU (kernel) and on the CPU
    (plain path) with the same frozen weights agree within 1e-4."""
    from repro_torch.models import model_zoo
    from repro_torch.serving import freeze_params

    cfg = cfg_full.reduced()
    params_cpu = freeze_params(model_zoo.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    outs = {}
    for dev in ("cpu", "cuda"):
        params = _to(torch, params_cpu, dev)
        pools = model_zoo.init_paged_cache(cfg, 2, 5, 16, device=dev)
        table = torch.tensor([[1, 2], [3, 4]], device=dev)
        view = model_zoo.gather_cache_view(pools, table)
        t = 12
        tokens = torch.arange(t, device=dev) * 37 % cfg.vocab_size
        slot = torch.tensor([0] * 7 + [1] * 4 + [2], device=dev)
        pos = torch.tensor(list(range(7)) + list(range(4)) + [0], device=dev)
        emit = torch.tensor([6, 10], device=dev)
        logits, _ = model_zoo.flat_step(cfg, params, tokens, slot, pos, view, emit)
        outs[dev] = logits.cpu()
    _require(torch.allclose(outs["cuda"], outs["cpu"], rtol=1e-4, atol=1e-4),
             "reduced flat_step on the GPU disagrees with the CPU")
    print(f"reduced flat_step GPU vs CPU: max abs diff "
          f"{(outs['cuda'] - outs['cpu']).abs().max().item():.3g} (tol 1e-4)", flush=True)


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile 4 decode steps with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch.configs as configs
    from repro_torch.kernels import _build

    # 1. card
    print(gpu_line(), flush=True)      # name, power limit, as nvidia-smi prints them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load("tsar_matmul")
    log = _build.build_logs.get("tsar_matmul")
    print(f"build: tsar_matmul {'compiled' if log is not None else 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in (log or "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  tsar_matmul: {line.strip()}")

    cfg = configs.get(ARCH)
    # 3. kernels
    kern = kernel_phase(torch, cfg)
    # 4. engine
    launches = engine_phase(torch, cfg, profile=args.profile)["launches"]
    cpu_agreement(torch, cfg)

    # One N=4 pure-decode step: 30 layers x 7 projections.
    decode = [(4, k, m) for _, k, m in step_shapes(cfg)]
    tot = {key: sum(kern["rows"][s][key] for s in decode) * cfg.n_layers
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    entry = {"name": "tsar_matmul", "route": "cuda",
             "source": "src/repro_torch/csrc/tsar_matmul.cu",
             "replaces": "src/repro/kernels/tsar_matmul.py:124",
             "launches": launches, "max_abs_err": kern["max_abs_err"],
             "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
             "bound_by": ("bytes" if all(kern["rows"][s]["bound_by"] == "bytes"
                                         for s in decode) else "operations"),
             "library_ms": tot["library_ms"],
             "per": f"one N=4 decode step: {7 * cfg.n_layers} launches at the "
                    "bitnet-2b-4t shapes"}
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
