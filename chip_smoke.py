#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase; needs one CUDA GPU
    python3 chip_smoke.py --profile  # + torch.profiler over 4 decode steps

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit (``nvidia-smi``), its properties beside
   the planner's H100 constants (``repro_torch.core.hw``);
2. build the three CUDA libraries from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together) and print the build time and
   ``nvcc``'s register report;
3. ``tsar_matmul`` kernel phase: the kernel against its plain PyTorch
   version at the eight (N, K, M) shapes of the ``bitnet-2b-4t`` serving step,
   at N in {1, 8, 9, 32, 33} x 2560 x 6912, at 20 x 2576 x 2576 and
   4 x 6928 x 80 (TMA boxes partly past the matrix), at 33 x 200 x 132 and
   at ragged shapes, required ``torch.equal``; CUDA-event times (median of 21
   CUDA-graph replays, each cycling over enough weight copies to defeat the
   50 MB L2) beside the bound and ``torch._int_mm`` on pre-decoded int8
   weights; the launch structure: ``torch.profiler`` over 4 eager calls at
   4 x 2560 x 6912 must show exactly 4 device kernels and no memset;
4. ``tsar_sparse_padded`` kernel phase: the same eight shapes on padded
   pools with half of the (256, 256) blocks dead (numpy seed 0), plus
   ragged N/K/M, N = 33 (two row tiles), an empty strip inside a cluster of
   more than one CTA, all-zero activations, (64, 36) blocks (bm padded for
   TMA), (40, 36) blocks (bk padded, a ragged Kp) and a walk longer than
   the ring (N = 33 on full-grid pools: two ring stages take turns),
   required ``torch.equal`` to the plain version and two calls on the same
   inputs ``torch.equal``; times beside the bound of the live blocks, the
   dense ``tsar_matmul`` on the same decoded matrix and ``torch._int_mm``;
   the launch structure as for ``tsar_matmul`` (4 calls -> 4 device
   kernels, no memset, nothing else);
5. ``tsar_lut`` kernel phase: the four projection shapes x N in {1, 4, 20},
   c = 4, float32 activations, indices from ``pack_indices`` (numpy seed
   0), within rtol 1e-4 / atol 2e-3 of the plain version and of the dense
   product, two calls on the same inputs ``torch.equal``; c in {1, 2, 5, 8}
   at 4 x 2560 x 2560, ragged N/K/M, N in {1, 33} x 2600 x 2600 and
   33 x 2598 x 200 at c = 3 (TMA boxes past the matrix, padded blocks and
   columns); times beside the bound, the plain version and one float32
   ``torch.matmul`` (TF32 off) on the decoded ``t * scale``; the launch
   structure as for ``tsar_matmul`` (4 calls -> 4 device kernels, nothing
   else);
6. ``tsar_sparse`` (compacted pool) kernel phase: the four projection
   shapes x N in {1, 4, 20} on ``from_ternary`` pools with half of the
   (256, 256) blocks dead, required ``torch.equal``; an all-dead matrix, an
   empty strip inside a cluster of more than one CTA, ragged N/K/M, (64, 36)
   and (40, 36) blocks, two calls ``torch.equal``; times beside the
   live-block bound, the padded kernel on the same matrix and
   ``torch._int_mm``; the launch structure (4 calls -> 4 device kernels);
7. dense engine phase: full-width ``bitnet-2b-4t`` (30 layers, random
   weights from seed 0) served through ``ServingEngine(device="cuda")`` with
   its defaults (``sparse="auto"``, compiled plan): random absmean weights
   keep every block live, so the plan names only planes kernels and
   ``tsar_matmul`` must launch 210 x steps times; 8 requests finish, every
   logit is finite; a real ``w_gate`` projection at N=20 equals its plain
   version; a reduced-config step on the GPU agrees with the CPU within 1e-4;
8. block-sparse engine phase: the same model with a seeded half of every
   projection's (256, 256) blocks zeroed (block (0, 0) always): pools for
   all 7 projections, a plan of ``tsar_sparse_padded``, both launch counts
   equal to what the plan predicts over the run's steps, and greedy tokens
   equal to engines pinned to ``tsar_mxu`` by a hand-edited plan; the two
   routes run in turns (sparse, mxu, mxu, sparse) for their step times;
9. bitlinear path phase: the seven projections of one full-width layer
   (numpy seed 0), frozen on the card by ``core.bitlinear.freeze`` dense and
   with a seeded half of their (256, 256) latent blocks zeroed (block (0, 0)
   always), ``compile_plan`` over the 14 ``FrozenBitLinear``s, then
   ``apply_frozen`` at N in {1, 4, 20} under auto, the compiled
   ``LayerPlan``s and each of the six registry names: launch counts equal
   what the resolved kernels predict, the int8 family equal to the quantized
   oracle, the float family within rtol 1e-4 / atol 2e-3 of the dense
   product, bf16 in gives bf16 out.

Each engine run and each bitlinear run is a path: every launch count is set
to 0 just before it and read just after.  The card's name and power limit
are printed again before the ``{"kernels": [...]}`` line, which comes
before the last; the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import gc
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
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores

ARCH = "bitnet-2b-4t"
KERNEL_SOURCES = ("tsar_matmul", "tsar_sparse", "tsar_lut")
# Registry kernel -> the launch counter of its hand-written kernel
# (``memory_lut`` and ``dense`` are plain PyTorch and launch none).
COUNTER_OF = {"tsar_mxu": "tsar_matmul", "tsar_lut": "tsar_lut",
              "tsar_sparse": "tsar_sparse", "tsar_sparse_padded": "tsar_sparse_padded"}
COUNTERS = ("tsar_matmul", "tsar_sparse_padded", "tsar_lut", "tsar_sparse")
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


def sparse_bound(n: int, kp: int, bk: int, bm: int, mb: int, s_steps: int,
                 live: int) -> tuple[float, str]:
    """Least time (ms) for one ``tsar_sparse_padded`` call on this data: the
    larger of the bytes it must move (the live blocks' planes
    live * 2 * bk/8 * bm, int8 activations N*Kp, f32 a_scale 4N, f32 output
    4*N*Mp, f32 w_scale 4*Mp, the int32 schedule 4*(2*mb*s_steps + mb)) over
    HBM bandwidth and its int8 ops 2*N*bk*bm*live over the int8 peak."""
    mp = mb * bm
    nbytes = (live * 2 * (bk // 8) * bm + n * kp + 4 * n + 4 * n * mp + 4 * mp
              + 4 * (2 * mb * s_steps + mb))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n * bk * bm * live / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lut_bound(n: int, k: int, m: int, c: int) -> tuple[float, str]:
    """Least time (ms) for one ``tsar_lut`` call: the larger of the bytes it
    must move (uint8 indices 2*(K/c)*M, f32 activations 4*N*K, f32 output
    4*N*M, f32 w_scale 4*M) over HBM bandwidth and its float32 operations
    over the float32 peak outside the tensor cores: the LUT build
    N*(K/c)*2^c adds, then per (row, block, column) one FMA and one add
    (``acc += 2*S[ip] + S[iz]``), 3*N*(K/c)*M."""
    blocks = -(-k // c)
    nbytes = 2 * blocks * m + 4 * n * k + 4 * n * m + 4 * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n * blocks * (1 << c) + 3 * n * blocks * m) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_sparse_ternary(torch, rng, k: int, m: int, bk: int, bm: int, dev,
                         dead_strip: bool = False):
    """Ternary (K, M) int8 on ``dev`` with half of its (bk, bm) blocks dead
    (numpy ``rng``); ``dead_strip`` kills every block of m-strip 0."""
    import numpy as np

    kb, mb = -(-k // bk), -(-m // bm)
    dead = rng.random((kb, mb)) < 0.5
    if dead_strip:
        dead[:, 0] = True
    t = rng.integers(-1, 2, size=(k, m), dtype=np.int8)
    t *= np.repeat(np.repeat(~dead, bk, 0), bm, 1)[:k, :m].astype(np.int8)
    return torch.from_numpy(t).to(dev)


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
    # Edge shapes straight into the kernel: row counts around the 8-row
    # n-tiles and the 32-row CTA tile at one full-width shape; TMA boxes
    # partly past the matrix (M % 64 != 0, Kp % 32 != 0, both multiples of
    # 16); K and M not multiples of 16 (padded by the wrapper).
    edges = [(n, 2560, 6912) for n in (1, 8, 9, 32, 33)]
    edges += [(20, 2576, 2576), (4, 6928, 80), (33, 200, 132)]
    for n, k, m in edges:
        a_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
        w_scale = torch.rand((m,), generator=gen, device=dev) + 0.01
        s0, z0 = (torch.randint(0, 256, (k // 8, m), generator=gen, device=dev,
                                dtype=torch.uint8) for _ in range(2))
        got = tm.tsar_matmul_packed(a_q, a_scale, s0, z0, w_scale)
        want = tm.tsar_matmul_plain(a_q, a_scale, s0, z0, w_scale)
        _require(torch.equal(got, want), f"tsar_matmul != plain at edge N={n} K={k} M={m}")
        picks = tuple(tm.launch_config(n, k, m, tm._sm_count(0)))
        print(f"tsar_matmul edge N={n} K={k} M={m} {picks}: equal", flush=True)
    # Ragged shapes through the public entry point (K padded to 8 there).
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
    n, k, m = 4, 2560, 6912
    a_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
    w_scale = torch.rand((m,), generator=gen, device=dev) + 0.01
    s0, z0 = (torch.randint(0, 256, (k // 8, m), generator=gen, device=dev, dtype=torch.uint8)
              for _ in range(2))
    launch_structure(torch, "tsar_matmul",
                     lambda: tm.tsar_matmul_packed(a_q, a_scale, s0, z0, w_scale))
    return {"rows": rows, "max_abs_err": max_err}


def launch_structure(torch, name: str, call, calls: int = 4) -> None:
    """torch.profiler over ``calls`` eager calls of ``call`` (one wrapper
    call of kernel ``name`` at N=4 x 2560 x 6912): the device must run
    exactly one kernel per call (the cluster launch), ``<name>_kernel``, and
    nothing else: no memset, no epilogue kernel."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [k for k in device if f"{name}_kernel" in k]
    memsets = [k for k in device if "memset" in k.lower()]
    _require(len(kernels) == calls and len(device) == calls and not memsets,
             f"launch structure: {calls} calls ran {len(device)} device ops "
             f"({len(kernels)} {name} kernels, {len(memsets)} memsets): {device}")
    print(f"{name} launch structure: {calls} calls -> {len(kernels)} device kernels "
          f"({kernels[0][:60]}...), 0 memsets, no other device op", flush=True)


def sparse_kernel_phase(torch, cfg) -> dict:
    import numpy as np

    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tsar_matmul as tm
    from repro_torch.kernels import tsar_sparse as ts
    from repro_torch.sparse import format as sformat

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(3)
    bk = bm = 256
    rows = {}
    max_err = 0.0
    distinct = sorted({(k, m) for _, k, m in step_shapes(cfg)})
    for n in (4, 20):
        for k, m in distinct:
            t = block_sparse_ternary(torch, rng, k, m, bk, bm, dev)
            w_scale = torch.rand((m,), generator=gen, device=dev) + 0.01
            full = sformat.pad_from_ternary(t, w_scale, bk, bm)
            live, s_max = int(full.counts.sum()), int(full.counts.max())
            p = sformat.pad_from_ternary(t, w_scale, bk, bm, max_live=live, s_steps=s_max)
            kb, mb = p.grid
            a_q = torch.randint(-127, 128, (n, kb * bk), generator=gen, device=dev,
                                dtype=torch.int8)
            a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
            wsc = torch.nn.functional.pad(w_scale, (0, mb * bm - m))
            sched = (p.kids, p.slots, p.counts, wsc)
            got = ts.tsar_sparse_padded_matmul_packed(a_q, a_scale, p.sign_pool,
                                                      p.zero_pool, *sched)
            want = ts.tsar_sparse_padded_plain(a_q, a_scale, p.sign_pool, p.zero_pool,
                                               *sched)
            err = (got - want).abs().max().item()
            _require(torch.equal(got, want), f"tsar_sparse_padded != plain at N={n} "
                     f"K={k} M={m} (max err {err})")
            max_err = max(max_err, err)
            live_bytes = live * 2 * (bk // 8) * bm
            copies = max(2, min(256, math.ceil(2 * L2_BYTES / max(live_bytes, 1))))
            pools = [(p.sign_pool.clone(), p.zero_pool.clone()) for _ in range(copies)]
            ms = time_graph(torch, [
                (lambda s=s, z=z: ts.tsar_sparse_padded_matmul_packed(
                    a_q, a_scale, s, z, *sched)) for s, z in pools],
                launches_per_replay=2 * copies)
            plain_ms = time_eager(torch, lambda: ts.tsar_sparse_padded_plain(
                a_q, a_scale, p.sign_pool, p.zero_pool, *sched))
            # The dense kernel on the same decoded matrix (planes, all blocks).
            tw = ternary.pack(t, w_scale)
            a_k = a_q[:, :k].contiguous()
            dcopies = max(2, min(256, math.ceil(2 * L2_BYTES / (k * m / 4))))
            planes = [(tw.sign_plane.clone(), tw.zero_plane.clone()) for _ in range(dcopies)]
            dense_ms = time_graph(torch, [
                (lambda s=s, z=z: tm.tsar_matmul_packed(a_k, a_scale, s, z, tw.scale))
                for s, z in planes], launches_per_replay=2 * dcopies)
            a32 = torch.zeros((32, k), dtype=torch.int8, device=dev)
            a32[:n] = a_k
            lib_copies = max(2, min(64, math.ceil(2 * L2_BYTES / (k * m))))
            w8 = [t.clone() for _ in range(lib_copies)]
            library_ms = time_graph(torch, [
                (lambda w=w: torch._int_mm(a32, w)) for w in w8],
                launches_per_replay=2 * lib_copies)
            b_ms, b_by = sparse_bound(n, kb * bk, bk, bm, mb, s_max, live)
            rows[(n, k, m)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": library_ms,
                               "dense_ms": dense_ms}
            print(f"tsar_sparse_padded N={n:2d} K={k} M={m} live {live}/{kb * mb} "
                  f"blocks (s_steps {s_max}): equal | {ms * 1e3:.2f} us (bound "
                  f"{b_ms * 1e3:.2f} us, {b_by}; {b_ms / ms:.1%} of bound) | dense "
                  f"tsar_matmul {dense_ms * 1e3:.2f} us | plain {plain_ms * 1e3:.1f} us | "
                  f"_int_mm int8 {library_ms * 1e3:.2f} us", flush=True)
            del pools, planes, w8
    # Through the public wrapper: ragged N/K/M, N = 33 (two row tiles), an
    # empty strip inside a cluster of more than one CTA, all-zero
    # activations, (64, 36) blocks (bm padded to 48 for TMA), (40, 36)
    # blocks (bk padded to 48: Kp = 200 is not a multiple of 16) and a walk
    # longer than the ring (full-grid pools at N = 33: two stages take turns).
    cases = [(1, 200, 130, 64, 64, "ragged"), (33, 200, 130, 64, 64, "N=33"),
             (4, 200, 130, 64, 64, "empty strip"), (20, 512, 512, 64, 64, "zero activations"),
             (4, 256, 144, 64, 36, "(64, 36) blocks"), (33, 200, 100, 40, 36, "(40, 36) blocks"),
             (33, 6912, 6912, 256, 256, "ring turnover")]
    for n, k, m, cbk, cbm, what in cases:
        t = block_sparse_ternary(torch, rng, k, m, cbk, cbm, dev,
                                 dead_strip=what == "empty strip")
        p = sformat.pad_from_ternary(t, torch.rand((m,), generator=gen, device=dev) + 0.01,
                                     cbk, cbm)
        x = torch.randn((n, k), generator=gen, device=dev)
        if what == "zero activations":
            x[::3] = 0.0
            x[:, 64:128] = 0.0
        got = ops.tsar_sparse_padded_matmul(x, p)
        want = ref.padded_sparse_matmul_ref(x, p)
        _require(got.shape == (n, m), f"sparse output shape {tuple(got.shape)}")
        picks = ts.launch_config(n, -(-cbk // 16) * 16, -(-cbm // 16) * 16, p.grid[1],
                                 p.s_steps, ts._sm_count(0))
        if what == "empty strip":
            _require(int(p.counts[0]) == 0 and picks.cluster > 1,
                     f"strip 0 has {int(p.counts[0])} live blocks, cluster {picks.cluster}")
        _require(what != "ring turnover" or picks.stages == 2, f"ring {tuple(picks)}")
        _require(torch.equal(got, want), f"tsar_sparse_padded != plain at N={n} K={k} "
                 f"M={m} ({cbk}, {cbm}) blocks ({what})")
        _require(torch.equal(ops.tsar_sparse_padded_matmul(x, p), got),
                 f"tsar_sparse_padded N={n} K={k} M={m} ({what}): two calls differ")
        print(f"tsar_sparse_padded N={n} K={k} M={m} ({cbk}, {cbm}) blocks, {what}, "
              f"counts {p.counts.tolist()[:8]} {tuple(picks)}: equal, two calls equal",
              flush=True)
    n, k, m = 4, 2560, 6912
    t = block_sparse_ternary(torch, rng, k, m, bk, bm, dev)
    p = sformat.pad_from_ternary(t, torch.rand((m,), generator=gen, device=dev) + 0.01, bk, bm)
    a_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
    launch_structure(torch, "tsar_sparse", lambda: ts.tsar_sparse_padded_matmul_packed(
        a_q, a_scale, p.sign_pool, p.zero_pool, p.kids, p.slots, p.counts, p.scale))
    return {"rows": rows, "max_abs_err": max_err}


def lut_kernel_phase(torch, cfg) -> dict:
    import numpy as np

    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tsar_lut as tl

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    c = 4
    rows = {}
    max_err = 0.0

    def problem(n, k, m):
        x = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)).to(dev)
        t = torch.from_numpy(rng.integers(-1, 2, size=(k, m), dtype=np.int8)).to(dev)
        w_scale = torch.from_numpy(rng.uniform(0.25, 2.0, m).astype(np.float32)).to(dev)
        return x, t, w_scale

    def check(got, x, t, w_scale, ip, iz, c, what):
        plain = tl.tsar_lut_plain(x, ip, iz, w_scale, c)
        dense = ref.ternary_matmul_ref(x, t, w_scale)
        err = (got - plain).abs().max().item()
        _require(bool(torch.isfinite(got).all()), f"tsar_lut {what}: non-finite output")
        _require(torch.allclose(got, plain, rtol=1e-4, atol=2e-3),
                 f"tsar_lut != plain at {what} (max err {err})")
        _require(torch.allclose(got, dense, rtol=1e-4, atol=2e-3),
                 f"tsar_lut != dense product at {what} "
                 f"(max err {(got - dense).abs().max().item()})")
        return err

    distinct = sorted({(k, m) for _, k, m in step_shapes(cfg)})
    for k, m in distinct:
        _, t, w_scale = problem(1, k, m)
        ip, iz = ternary.pack_indices(t, c)
        copies = max(2, min(256, math.ceil(2 * L2_BYTES / (2 * ip.numel()))))
        idx = [(ip.clone(), iz.clone()) for _ in range(copies)]
        # Library yardstick: one float32 torch.matmul (TF32 off) on the
        # matrix t * scale decoded ahead of time (16x the index bytes).
        w = t.to(torch.float32) * w_scale
        lib_copies = max(2, min(64, math.ceil(2 * L2_BYTES / (4 * k * m))))
        wl = [w.clone() for _ in range(lib_copies)]
        for n in (1, 4, 20):
            x = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)).to(dev)
            got = tl.tsar_lut_gemv(x, ip, iz, w_scale, c=c)
            err = check(got, x, t, w_scale, ip, iz, c, f"N={n} K={k} M={m} c={c}")
            _require(torch.equal(tl.tsar_lut_gemv(x, ip, iz, w_scale, c=c), got),
                     f"tsar_lut N={n} K={k} M={m}: two calls on the same inputs differ")
            max_err = max(max_err, err)
            ms = time_graph(torch, [
                (lambda p=p, z=z: tl.tsar_lut_gemv(x, p, z, w_scale, c=c)) for p, z in idx],
                launches_per_replay=2 * copies)
            plain_ms = time_eager(torch, lambda: tl.tsar_lut_plain(x, ip, iz, w_scale, c))
            library_ms = time_graph(torch, [(lambda w=w: torch.matmul(x, w)) for w in wl],
                                    launches_per_replay=2 * lib_copies)
            b_ms, b_by = lut_bound(n, k, m, c)
            rows[(n, k, m)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": library_ms}
            print(f"tsar_lut N={n:2d} K={k} M={m} c={c}: within rtol 1e-4/atol 2e-3 "
                  f"(max err {err:.3g}), two calls equal | {ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us, "
                  f"{b_by}; {b_ms / ms:.1%} of bound) | plain {plain_ms * 1e3:.1f} us | "
                  f"f32 torch.matmul {library_ms * 1e3:.2f} us", flush=True)
        del idx, wl, w
    # Through the public wrapper: c in {1, 2, 5, 8} at a full-width shape;
    # ragged N/K/M (ops zero-pads K to blocks * c, the kernel's wrapper pads
    # blocks so that blocks * c % 4 == 0 and M to 16); N in {1, 33} x 2600 x
    # 2600 (TMA boxes past the matrix in M and in the blocks, a second row
    # tile) and 33 x 2598 x 200 at c = 3 (blocks padded, M padded).
    edges = [(4, 2560, 2560, cc) for cc in (1, 2, 5, 8)]
    edges += [(1, 132, 70, 4), (33, 132, 70, 4), (1, 132, 70, 2), (33, 132, 70, 2),
              (1, 2600, 2600, 4), (33, 2600, 2600, 4), (33, 2598, 200, 3)]
    for n, k, m, cc in edges:
        x, t, w_scale = problem(n, k, m)
        ip, iz = ternary.pack_indices(t, cc)
        got = ops.tsar_lut_gemv(x, ip, iz, w_scale, c=cc)
        _require(got.shape == (n, m), f"tsar_lut output shape {tuple(got.shape)}")
        err = check(got, x, t, w_scale, ip, iz, cc, f"N={n} K={k} M={m} c={cc}")
        _require(torch.equal(ops.tsar_lut_gemv(x, ip, iz, w_scale, c=cc), got),
                 f"tsar_lut N={n} K={k} M={m} c={cc}: two calls on the same inputs differ")
        max_err = max(max_err, err)
        print(f"tsar_lut N={n} K={k} M={m} c={cc}: within rtol 1e-4/atol 2e-3 "
              f"(max err {err:.3g}), two calls equal", flush=True)
    n, k, m = 4, 2560, 6912
    x, t, w_scale = problem(n, k, m)
    ip, iz = ternary.pack_indices(t, c)
    launch_structure(torch, "tsar_lut", lambda: tl.tsar_lut_gemv(x, ip, iz, w_scale, c=c))
    return {"rows": rows, "max_abs_err": max_err}


def compact_kernel_phase(torch, cfg) -> dict:
    import numpy as np

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tsar_sparse as ts
    from repro_torch.sparse import format as sformat

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(4)
    bk = bm = 256
    rows = {}
    max_err = 0.0
    distinct = sorted({(k, m) for _, k, m in step_shapes(cfg)})
    for n in (1, 4, 20):
        for k, m in distinct:
            t = block_sparse_ternary(torch, rng, k, m, bk, bm, dev)
            w_scale = torch.rand((m,), generator=gen, device=dev) + 0.01
            p = sformat.from_ternary(t, w_scale, bk, bm)
            kb, mb = p.grid
            a_q = torch.randint(-127, 128, (n, kb * bk), generator=gen, device=dev,
                                dtype=torch.int8)
            a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
            wsc = torch.nn.functional.pad(w_scale, (0, mb * bm - m))
            sched = (p.kids, p.slots, p.counts, wsc)
            got = ts.tsar_sparse_matmul_packed(a_q, a_scale, p.sign_pool, p.zero_pool,
                                               *sched)
            want = ts.tsar_sparse_compact_plain(a_q, a_scale, p.sign_pool, p.zero_pool,
                                                *sched)
            err = (got - want).abs().max().item()
            _require(torch.equal(got, want), f"tsar_sparse != plain at N={n} K={k} M={m} "
                     f"(max err {err})")
            max_err = max(max_err, err)
            live = p.n_live
            copies = max(2, min(256, math.ceil(2 * L2_BYTES / max(live * 2 * (bk // 8) * bm, 1))))
            pools = [(p.sign_pool.clone(), p.zero_pool.clone()) for _ in range(copies)]
            ms = time_graph(torch, [
                (lambda s=s, z=z: ts.tsar_sparse_matmul_packed(a_q, a_scale, s, z, *sched))
                for s, z in pools], launches_per_replay=2 * copies)
            plain_ms = time_eager(torch, lambda: ts.tsar_sparse_compact_plain(
                a_q, a_scale, p.sign_pool, p.zero_pool, *sched))
            # The padded kernel on the same matrix (its tight pool).
            q = sformat.pad_pool(p)
            qsched = (q.kids, q.slots, q.counts, wsc)
            qpools = [(q.sign_pool.clone(), q.zero_pool.clone()) for _ in range(copies)]
            padded_ms = time_graph(torch, [
                (lambda s=s, z=z: ts.tsar_sparse_padded_matmul_packed(
                    a_q, a_scale, s, z, *qsched)) for s, z in qpools],
                launches_per_replay=2 * copies)
            a32 = torch.zeros((32, k), dtype=torch.int8, device=dev)
            a32[:n] = a_q[:, :k]
            lib_copies = max(2, min(64, math.ceil(2 * L2_BYTES / (k * m))))
            w8 = [t.clone() for _ in range(lib_copies)]
            library_ms = time_graph(torch, [
                (lambda w=w: torch._int_mm(a32, w)) for w in w8],
                launches_per_replay=2 * lib_copies)
            b_ms, b_by = sparse_bound(n, kb * bk, bk, bm, mb, max(p.s_max, 1), live)
            rows[(n, k, m)] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": library_ms,
                               "padded_ms": padded_ms}
            print(f"tsar_sparse N={n:2d} K={k} M={m} live {live}/{kb * mb} blocks "
                  f"(s_max {p.s_max}): equal | {ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us, "
                  f"{b_by}; {b_ms / ms:.1%} of bound) | padded kernel {padded_ms * 1e3:.2f} us"
                  f" | plain {plain_ms * 1e3:.1f} us | _int_mm int8 "
                  f"{library_ms * 1e3:.2f} us", flush=True)
            del pools, qpools, w8
    # Through the public wrapper: an all-dead matrix (one pad slot, every
    # count 0), an empty strip inside a cluster of more than one CTA, ragged
    # N/K/M, (64, 36) and (40, 36) blocks.
    cases = [(4, 512, 256, 64, 64, "all dead"), (4, 200, 130, 64, 64, "empty strip"),
             (1, 200, 130, 64, 64, "ragged"), (33, 200, 130, 64, 64, "ragged"),
             (4, 256, 144, 64, 36, "(64, 36) blocks"), (33, 200, 100, 40, 36, "(40, 36) blocks")]
    for n, k, m, cbk, cbm, what in cases:
        if what == "all dead":
            t = torch.zeros((k, m), dtype=torch.int8, device=dev)
        else:
            t = block_sparse_ternary(torch, rng, k, m, cbk, cbm, dev,
                                     dead_strip=what == "empty strip")
        p = sformat.from_ternary(t, torch.rand((m,), generator=gen, device=dev) + 0.01,
                                 cbk, cbm)
        x = torch.randn((n, k), generator=gen, device=dev)
        got = ops.tsar_sparse_matmul(x, p)
        want = ref.block_sparse_matmul_ref(x, p)
        _require(got.shape == (n, m), f"tsar_sparse output shape {tuple(got.shape)}")
        _require(what != "all dead" or (p.n_live == 0 and p.sign_pool.shape[0] == 1
                                        and not bool(got.any())), "all-dead pool")
        picks = ts.launch_config(n, -(-cbk // 16) * 16, -(-cbm // 16) * 16, p.grid[1],
                                 max(p.s_max, 1), ts._sm_count(0))
        _require(what != "empty strip" or (int(p.counts[0]) == 0 and picks.cluster > 1),
                 f"strip 0 has {int(p.counts[0])} live blocks, cluster {picks.cluster}")
        _require(torch.equal(got, want), f"tsar_sparse != plain at N={n} K={k} M={m} ({what})")
        _require(torch.equal(ops.tsar_sparse_matmul(x, p), got),
                 f"tsar_sparse N={n} K={k} M={m} ({what}): two calls differ")
        print(f"tsar_sparse N={n} K={k} M={m} ({cbk}, {cbm}) blocks, {what} (live {p.n_live}, "
              f"s_max {p.s_max}) {tuple(picks)}: equal, two calls equal", flush=True)
    n, k, m = 4, 2560, 6912
    t = block_sparse_ternary(torch, rng, k, m, bk, bm, dev)
    p = sformat.from_ternary(t, torch.rand((m,), generator=gen, device=dev) + 0.01, bk, bm)
    a_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
    launch_structure(torch, "tsar_sparse", lambda: ts.tsar_sparse_matmul_packed(
        a_q, a_scale, p.sign_pool, p.zero_pool, p.kids, p.slots, p.counts, p.scale))
    return {"rows": rows, "max_abs_err": max_err}


def bitlinear_phase(torch, cfg) -> dict:
    """The layer-level path: ``freeze`` -> ``compile_plan`` ->
    ``apply_frozen`` over the seven projections of one full-width layer,
    frozen dense and with half of the (256, 256) latent blocks zeroed."""
    import numpy as np

    from repro_torch.core import bitlinear, ternary
    from repro_torch.kernels import ref
    from repro_torch.plan import BatchProfile, compile_plan, registry

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    frozen = {}
    t0 = time.perf_counter()
    for proj, k, m in step_shapes(cfg):
        w = torch.from_numpy(rng.standard_normal((k, m), dtype=np.float32)).to(dev)
        w /= math.sqrt(k)
        dead = rng.random((-(-k // 256), -(-m // 256))) < 0.5
        dead[0, 0] = True
        live = torch.from_numpy(~dead).to(dev)
        mask = live.repeat_interleave(256, 0).repeat_interleave(256, 1)[:k, :m]
        frozen[f"dense/{proj}"] = bitlinear.freeze({"w": w})
        frozen[f"sparse/{proj}"] = bitlinear.freeze({"w": w * mask})
    torch.cuda.synchronize()
    t_freeze = time.perf_counter() - t0
    for name, fz in frozen.items():
        sparse = name.startswith("sparse/")
        _require((fz.sparse is not None) == sparse and (fz.padded is not None) == sparse,
                 f"{name}: sidecars {fz.sparse is not None}/{fz.padded is not None} "
                 f"at block density {fz.block_density:.3f}")
    plan = compile_plan(frozen, BatchProfile(decode_ns=(1, 4), prefill_ns=(20,)))
    density = {name: round(fz.block_density, 3) for name, fz in frozen.items()}
    print(f"bitlinear: froze 14 full-width projections on the card in {t_freeze:.2f} s; "
          f"live-block fractions {density}", flush=True)
    print("bitlinear: compiled plan kernel counts "
          f"{ {n: plan.kernel_counts(n) for n in plan.buckets} }", flush=True)

    t_of = {name: ternary.unpack(fz.packed) for name, fz in frozen.items()}
    plans = ["auto", "compiled"] + list(registry.names())
    totals = dict.fromkeys(COUNTERS, 0)
    for n in (1, 4, 20):
        xs = {k: torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)).to(dev)
              for k in {fz.shape[0] for fz in frozen.values()}}
        exact = {name: ref.quantized_matmul_ref(xs[fz.shape[0]], fz.packed)
                 for name, fz in frozen.items()}
        fp = {name: ref.ternary_matmul_ref(xs[fz.shape[0]], t_of[name], fz.packed.scale)
              for name, fz in frozen.items()}
        auto = {name: bitlinear.resolve_kernel(fz, n) for name, fz in frozen.items()}
        for name, kern in auto.items():
            want = "tsar_sparse" if name.startswith("sparse/") else plan.lookup(name, n).kernel
            _require(kern == want, f"auto names {kern} for {name} at N={n}, expected {want}")
        print(f"bitlinear N={n}: auto resolves "
              f"{ {name: kern for name, kern in auto.items()} }", flush=True)
        for label in plans:
            spec = {name: (None if label == "auto" else plan.lookup(name, n)
                           if label == "compiled" else label) for name in frozen}
            layers = [name for name in frozen if label in ("auto", "compiled")
                      or registry.get(label).supports(frozen[name])]
            resolved = {name: bitlinear.resolve_kernel(frozen[name], n, spec[name])
                        for name in layers}
            want = dict.fromkeys(COUNTERS, 0)
            for kern in resolved.values():
                if kern in COUNTER_OF:
                    want[COUNTER_OF[kern]] += 1
            if label in COUNTER_OF:
                _require(want[COUNTER_OF[label]] == len(layers) and
                         len(layers) == (14 if label in ("tsar_mxu", "tsar_lut") else 7),
                         f"plan={label} covers {len(layers)} projections")
            if label == "auto":
                _require(want["tsar_sparse"] == 7, f"auto: {want}")
            zero_launch_counts()
            t0 = time.perf_counter()
            outs = {name: bitlinear.apply_frozen(frozen[name], xs[frozen[name].shape[0]],
                                                 plan=spec[name]) for name in layers}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = launch_counts()
            _require(got == want, f"bitlinear N={n} plan={label}: launches {got}, the "
                     f"resolved kernels predict {want}")
            for key in COUNTERS:
                totals[key] += got[key]
            for name, y in outs.items():
                kern = resolved[name]
                what = f"bitlinear N={n} plan={label} {name} ({kern})"
                _require(y.dtype == torch.float32 and y.shape == exact[name].shape and
                         bool(torch.isfinite(y).all()), f"{what}: bad output")
                if kern in ("tsar_mxu", "tsar_sparse", "tsar_sparse_padded"):
                    _require(torch.equal(y, exact[name]), f"{what} != quantized oracle")
                else:
                    _require(torch.allclose(y, fp[name], rtol=1e-4, atol=2e-3),
                             f"{what} != fp oracle (max err "
                             f"{(y - fp[name]).abs().max().item()})")
            print(f"bitlinear N={n:2d} plan={label}: {len(layers)} projections, "
                  f"launches {got} = the resolved kernels' | int8 family equal to the "
                  f"quantized oracle, fp family within rtol 1e-4/atol 2e-3 | host "
                  f"{wall * 1e3:.1f} ms", flush=True)
    # bf16 activations come back bf16 through every kernel.
    fz = frozen["sparse/w_gate"]
    xb = torch.randn((4, fz.shape[0]), device=dev).to(torch.bfloat16)
    want = ref.quantized_matmul_ref(xb, fz.packed).to(torch.bfloat16)
    for kern in registry.names():
        y = bitlinear.apply_frozen(fz, xb, plan=kern)
        _require(y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all()),
                 f"bf16 through {kern}: {y.dtype}")
        _require(kern not in ("tsar_mxu", "tsar_sparse", "tsar_sparse_padded")
                 or torch.equal(y, want), f"bf16 through {kern} != quantized oracle")
    print("bitlinear: bf16 activations return bf16 through all six kernels", flush=True)
    return {"launches": totals}


def make_requests(request_cls, cfg) -> list:
    """The smoke traffic: 8 prompts of 16-128 tokens (numpy seed 0), 16 new
    tokens each."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [request_cls(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                    size=int(rng.integers(16, 129)),
                                                    dtype=np.int32),
                        max_new_tokens=16) for i in range(8)]


def _counter_dicts() -> list[dict]:
    from repro_torch.kernels import tsar_lut as tl
    from repro_torch.kernels import tsar_matmul as tm
    from repro_torch.kernels import tsar_sparse as ts

    return [tm.LAUNCHES, ts.LAUNCHES, tl.LAUNCHES]


def launch_counts() -> dict:
    """Every kernel's launch count, under the names of ``COUNTERS``."""
    counts = {k: v for d in _counter_dicts() for k, v in d.items()}
    _require(set(counts) == set(COUNTERS), f"launch counters {sorted(counts)}")
    return {name: counts[name] for name in COUNTERS}


def zero_launch_counts() -> None:
    for d in _counter_dicts():
        for key in d:
            d[key] = 0


def predicted_launches(engine, widths: list) -> dict:
    """Kernel launches the engine's plan predicts over steps of these widths:
    each projection's planned kernel at the step's bucket, remapped within
    the sparse family as ``models.layers._packed_linear`` does; a padded
    sparse kernel on a layer with pools is ``tsar_sparse_padded``, a planes
    kernel (or no plan entry) ``tsar_matmul``, once per stacked layer."""
    from repro_torch.plan import registry

    want = dict.fromkeys(COUNTERS, 0)
    for name, (k, m, _c) in engine.plan.shapes.items():
        node = engine.params
        for key in name.split("/"):
            node = node[key]
        layer = {key: v[0] for key, v in node.items()}
        for w in widths:
            lp = engine.plan.lookup_shape(k, m, w)
            kern = None if lp is None else lp.kernel
            if kern in registry.SPARSE_KERNELS:
                kern = next((kn for kn in registry.SPARSE_KERNELS
                             if registry.get(kn).supports(layer)), kern)
            impl = None if kern is None else registry.get(kern)
            if impl is not None and impl.serve_via_registry and impl.supports(layer):
                _require(kern == "tsar_sparse_padded",
                         f"{name} planned {kern}, which is no kernel of this path")
                want["tsar_sparse_padded"] += node["sign"].shape[0]
            else:
                want["tsar_matmul"] += node["sign"].shape[0]
    return want


def run_path(torch, engine, reqs, label: str) -> dict:
    """Serve ``reqs`` as one path: launch counts zeroed just before, read
    just after; every step's logits checked finite; every request must
    finish with 16 tokens in ``[0, vocab)``."""
    widths, finite = [], []
    plan_flat, sample = engine.sched.plan_flat, engine._sample

    def recording_plan_flat(*args, **kw):
        plan = plan_flat(*args, **kw)
        if hasattr(plan, "width"):
            widths.append(plan.width)
        return plan

    def checked_sample(logits, temps):
        finite.append(bool(torch.isfinite(logits).all().item()))
        return sample(logits, temps)

    engine.sched.plan_flat, engine._sample = recording_plan_flat, checked_sample
    zero_launch_counts()
    t0 = time.perf_counter()
    engine.run(reqs)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    vocab = engine.cfg.vocab_size
    _require(all(r.done and len(r.out_tokens) == 16 for r in reqs),
             f"{label}: not every request finished with 16 tokens")
    _require(all(0 <= t < vocab for r in reqs for t in r.out_tokens),
             f"{label}: a token outside [0, vocab)")
    _require(finite and all(finite), f"{label}: non-finite logits in a step")
    _require(len(widths) == engine.stats["steps"], f"{label}: unrecorded steps")
    want = predicted_launches(engine, widths)
    _require(launches == want, f"{label}: launches {launches}, the plan predicts {want}")
    decode_steps = engine.metrics.get("decode_steps").value
    prefill_steps = engine.metrics.get("prefill_steps").value
    n_tok = sum(len(r.out_tokens) for r in reqs)
    pct = engine.latency_percentiles()
    print(f"{label}: {len(reqs)} requests, {engine.stats['steps']} steps "
          f"({prefill_steps} with prefill), {engine.stats['prefill_tokens']} prompt "
          f"tokens, {n_tok} generated, wall {wall:.3f} s, {n_tok / wall:.1f} generated "
          f"tok/s | decode {engine.throughput():.1f} tok/s over {decode_steps} "
          f"pure-decode steps ({engine.stats['decode_s'] / max(1, decode_steps) * 1e3:.2f}"
          f" ms/step) | prefill steps "
          f"{engine.stats['prefill_s'] / max(1, prefill_steps) * 1e3:.2f} ms/step | "
          f"TTFT p50 {pct['ttft_s']['p50'] * 1e3:.1f} ms, TPOT p50 "
          f"{pct['tpot_s']['p50'] * 1e3:.2f} ms | launches {launches} = plan's prediction",
          flush=True)
    return {"launches": launches, "tokens": [r.out_tokens for r in reqs]}


def bitlinear_leaves(params) -> dict:
    """path -> frozen BitLinear dict (stacked over the layers)."""
    return {f"{b}/{n}": leaf for b, block in params["blocks"].items()
            for n, leaf in block.items() if isinstance(leaf, dict) and "sign" in leaf}


def init_frozen(torch, cfg, kill_blocks: bool):
    """Full-width random params (generator seed 0) frozen with the engine's
    defaults.  ``kill_blocks`` first zeroes a seeded half (numpy seed 0) of
    every BitLinear stack's (256, 256) weight blocks, block (0, 0) always."""
    import numpy as np

    from repro_torch.models import model_zoo
    from repro_torch.serving import freeze_params

    dev = torch.device("cuda")
    gc.collect()             # an earlier phase's engines hold reference cycles
    t0 = time.perf_counter()
    latents = model_zoo.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if kill_blocks:
        rng = np.random.default_rng(0)
        for block in ("attn", "mlp"):
            for name in sorted(latents["blocks"][block]):
                leaf = latents["blocks"][block][name]
                if set(leaf) != {"w"}:
                    continue
                n_l, k, m = leaf["w"].shape
                dead = rng.random((n_l, -(-k // 256), -(-m // 256))) < 0.5
                dead[:, 0, 0] = True
                live = torch.from_numpy(~dead).to(dev)
                for i in range(n_l):
                    mask = live[i].repeat_interleave(256, 0).repeat_interleave(256, 1)
                    leaf["w"][i].mul_(mask[:k, :m])
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
    return params


def engine_phase(torch, cfg, profile: bool = False) -> dict:
    import numpy as np

    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.serving import Request, ServingEngine

    dev = torch.device("cuda")
    params = init_frozen(torch, cfg, kill_blocks=False)

    def make_engine():
        return ServingEngine(cfg, params, max_len=256, batch_slots=4,
                             prefill_chunk=16, device=dev)

    make_engine().run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                               max_new_tokens=2)])          # warm-up, not measured
    engine = make_engine()
    kernels = {lp.kernel for by_n in engine.plan.layers.values() for lp in by_n.values()}
    _require(kernels <= {"tsar_mxu", "tsar_lut"}, f"dense plan names {kernels}")
    _require(not any("sp_sign" in leaf for leaf in bitlinear_leaves(params).values()),
             "absmean weights froze sparse pools")
    print(f"engine: plan kernels {sorted(kernels)} (planes route), block density mean "
          f"{engine.stats['block_density_mean']:.3f}", flush=True)
    run = run_path(torch, engine, make_requests(Request, cfg), "engine")
    per_step = 7 * cfg.n_layers
    _require(run["launches"]["tsar_matmul"] == per_step * engine.stats["steps"],
             f"tsar_matmul launched {run['launches']['tsar_matmul']} times, expected "
             f"{per_step} x {engine.stats['steps']}")

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
    return {"launches": run["launches"]["tsar_matmul"]}


def sparse_engine_phase(torch, cfg) -> dict:
    import dataclasses

    import numpy as np

    from repro_torch.plan import ModelPlan, format_plan
    from repro_torch.serving import Request, ServingEngine

    dev = torch.device("cuda")
    params = init_frozen(torch, cfg, kill_blocks=True)
    leaves = bitlinear_leaves(params)
    pooled = sorted(path for path, leaf in leaves.items() if "sp_sign" in leaf)
    _require(len(pooled) == 7, f"pools emitted for {pooled}, not all 7 projections")
    pool_bytes = sum(leaf[k].numel() for leaf in leaves.values() for k in ("sp_sign", "sp_zero"))
    plane_bytes = sum(leaf[k].numel() for leaf in leaves.values() for k in ("sign", "zero"))

    def make_engine(plan=None):
        return ServingEngine(cfg, params, max_len=256, batch_slots=4,
                             prefill_chunk=16, plan=plan, device=dev)

    make_engine().run([Request(uid=-1, prompt=np.arange(8, dtype=np.int32),
                               max_new_tokens=2)])          # warm-up, not measured
    engine = make_engine()
    print(format_plan(engine.plan, max_rows=12), flush=True)
    print(f"sparse engine: plan kernel counts at n=4 {engine.plan.kernel_counts(4)}, "
          f"at n=20 {engine.plan.kernel_counts(20)} | block density mean "
          f"{engine.stats['block_density_mean']:.3f} | pools {pool_bytes / 2**20:.1f} MiB "
          f"against planes {plane_bytes / 2**20:.1f} MiB ({pool_bytes / plane_bytes:.1%})",
          flush=True)
    run = run_path(torch, engine, make_requests(Request, cfg), "sparse engine")
    steps = engine.stats["steps"]
    _require(run["launches"] == {**dict.fromkeys(COUNTERS, 0),
                                 "tsar_sparse_padded": 7 * cfg.n_layers * steps},
             f"sparse engine launches {run['launches']}, expected "
             f"{7 * cfg.n_layers} x {steps} sparse")

    mxu = ModelPlan(buckets=engine.plan.buckets, shapes=dict(engine.plan.shapes), layers={
        name: {n: dataclasses.replace(lp, kernel="tsar_mxu") for n, lp in by_n.items()}
        for name, by_n in engine.plan.layers.items()})
    # The two routes on the same checkpoint in turns (sparse, mxu, mxu,
    # sparse): host time drifts within a call, so only turns compare them.
    decode_ms = {"tsar_sparse_padded": [engine.stats["decode_s"]
                                        / engine.metrics.get("decode_steps").value * 1e3]}
    decode_ms["tsar_mxu"] = []
    for label, plan in (("tsar_mxu", mxu), ("tsar_mxu", mxu),
                        ("tsar_sparse_padded", None)):
        eng = make_engine(plan)
        check = run_path(torch, eng, make_requests(Request, cfg),
                         f"sparse checkpoint, {label} plan")
        _require(check["tokens"] == run["tokens"],
                 f"tokens of the {label} plan differ from the main sparse run's")
        decode_ms[label].append(eng.stats["decode_s"]
                                / eng.metrics.get("decode_steps").value * 1e3)
    print("sparse engine: greedy tokens equal across the tsar_sparse_padded and "
          "all-tsar_mxu plans | decode ms/step in turns: sparse "
          f"{decode_ms['tsar_sparse_padded'][0]:.2f}, mxu {decode_ms['tsar_mxu'][0]:.2f}, "
          f"mxu {decode_ms['tsar_mxu'][1]:.2f}, sparse "
          f"{decode_ms['tsar_sparse_padded'][1]:.2f}", flush=True)
    return {"launches": run["launches"]["tsar_sparse_padded"]}


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
    props = torch.cuda.get_device_properties(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {props.name}: "
          f"{props.multi_processor_count} SMs, {props.total_memory / 2**30:.1f} GiB",
          flush=True)
    from repro_torch.core import hw
    print(f"planner constants (repro_torch.core.hw, H100 SXM data sheet): bf16 "
          f"{hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s, int8 {hw.PEAK_FLOPS_INT8 / 1e12:.0f} "
          f"TOP/s, HBM {hw.HBM_BW / 1e12:.2f} TB/s, shared memory {hw.SMEM_BYTES // 1024} "
          "KiB per SM", flush=True)

    # 2. build, one nvcc per source, started together
    t0 = time.perf_counter()
    _build.build(KERNEL_SOURCES)
    print(f"build: {', '.join(KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s "
          f"(compiled: {sorted(_build.build_logs) or 'none, cached'})", flush=True)
    for name in KERNEL_SOURCES:
        _build.load(name)
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(ARCH)
    # 3-6. kernels
    kern = kernel_phase(torch, cfg)
    sparse = sparse_kernel_phase(torch, cfg)
    lut_res = lut_kernel_phase(torch, cfg)
    compact = compact_kernel_phase(torch, cfg)
    # 7-9. paths, each run with the launch counts zeroed just before it
    launches = engine_phase(torch, cfg, profile=args.profile)["launches"]
    cpu_agreement(torch, cfg)
    sparse_launches = sparse_engine_phase(torch, cfg)["launches"]
    bl_launches = bitlinear_phase(torch, cfg)["launches"]

    # Per kernel, the seven projections at N=4: times 30 layers for the two
    # kernels of the serving step (one decode step), one layer for the two of
    # the bitlinear path.
    decode = [(4, k, m) for _, k, m in step_shapes(cfg)]
    half_dead = " on pools with half the (256, 256) blocks dead"
    entries = []
    for name, source, replaces, res, n_launch, layers, per in (
            ("tsar_matmul", "tsar_matmul.cu", "src/repro/kernels/tsar_matmul.py:124",
             kern, launches, cfg.n_layers, ""),
            ("tsar_sparse_padded", "tsar_sparse.cu", "src/repro/kernels/tsar_sparse.py:223",
             sparse, sparse_launches, cfg.n_layers, half_dead),
            ("tsar_lut", "tsar_lut.cu", "src/repro/kernels/tsar_lut.py:96",
             lut_res, bl_launches["tsar_lut"], 1, ", c=4"),
            ("tsar_sparse", "tsar_sparse.cu", "src/repro/kernels/tsar_sparse.py:122",
             compact, bl_launches["tsar_sparse"], 1, half_dead)):
        tot = {key: sum(res["rows"][sh][key] for sh in decode) * layers
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        entries.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": n_launch, "max_abs_err": res["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if all(res["rows"][sh]["bound_by"] == "bytes"
                                        for sh in decode) else "operations"),
            "library_ms": tot["library_ms"],
            "per": (f"one N=4 decode step: {7 * layers} launches at the bitnet-2b-4t "
                    f"shapes{per}" if layers > 1 else
                    f"one bitnet-2b-4t layer's 7 projections at N=4{per}; launches "
                    "over the bitlinear path's runs")})
    # The card again at the end: the first line is far above the tail of a
    # long log, and the limit is what every number above was taken under.
    print(gpu_line(), flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
