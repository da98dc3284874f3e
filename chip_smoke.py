#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase; needs one CUDA GPU
    python3 chip_smoke.py --profile  # + torch.profiler over 4 decode steps

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit (``nvidia-smi``), its properties beside
   the planner's H100 constants (``repro_torch.core.hw``);
2. build the four CUDA libraries from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together) and print the build time and
   ``nvcc``'s register report;
3. ``tsar_matmul`` kernel phase: the kernel against its plain PyTorch
   version at the four projection shapes of ``bitnet-2b-4t`` x N in
   {4, 20, 64, 77, 128} (the flat policy's decode and prefill widths, the
   chunked policy's 4 x 16 rows, a ragged and a full whole prompt), at
   N in {1, 8, 9, 32, 33} x 2560 x 6912, at 20 x 2576 x 2576 and
   4 x 6928 x 80 (TMA boxes partly past the matrix), at 33 x 200 x 132 and
   at ragged shapes, required ``torch.equal``; CUDA-event times (median of 21
   CUDA-graph replays, each cycling over enough weight copies to defeat the
   50 MB L2) beside the bound and ``torch._int_mm`` on pre-decoded int8
   weights; the launch structure: ``torch.profiler`` over two cycles of 4
   eager calls at 4 x 2560 x 6912: the second must show exactly 4 device
   kernels and no memset, the first's device ops a subset of those;
4. ``tsar_sparse_padded`` kernel phase: the four shapes x N in
   {4, 20, 64, 128} on padded pools with half of the (256, 256) blocks
   dead (numpy seed 0), plus
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
6b. ``flat_attn`` kernel phase (``csrc/flat_attn.cu``, the flat step's
   float64 attention core; it replaces no TPU kernel): ``bitnet-2b-4t``'s
   heads over the benchmark cell's (48, 2048) float32 cache view, at T 48
   (a decode row in every slot) and T 304 (47 decode rows, a 256-row prompt
   chunk of slot 47 at positions 600-855, one padding row), the decode
   rows' positions ShareGPT-like live lengths; through the route
   ``layers.flat_context``: every real row within one float32 ulp of the
   plain version ``layers._flat_context`` on the same tensors, padding rows
   zero, two calls equal, one launch a call; times beside the bound (live
   K/V rows read once over HBM bandwidth, or the float64 operations over
   the float64 peak) and the plain version; the launch structure (4 calls
   -> 4 device kernels, nothing else);
7. family kernel phase: ``tsar_matmul`` at every (K, M) of the
   projections that run it in full-width ``deepseek-moe-16b`` (attention,
   shared experts), ``mamba2-780m`` (``in_proj``, ``out_proj``) and
   ``hymba-1.5b`` (attention, MLP, ``in_proj``, ``out_proj``) x N in
   {3, 4, 20, 64, 128}, required ``torch.equal``; times at N = 4 and 20
   beside the bound and ``torch._int_mm``, and where the wrapper pads K or M
   to 16 on every call, the kernel alone on inputs padded ahead of time;
8. dense engine phase: full-width ``bitnet-2b-4t`` (30 layers, random
   weights from seed 0) served through ``ServingEngine(device="cuda")`` with
   its defaults (``sparse="auto"``, compiled plan): random absmean weights
   keep every block live, so the plan names only planes kernels and
   ``tsar_matmul`` must launch 210 x steps times; 8 requests finish, every
   logit is finite; a real ``w_gate`` projection at N=20 equals its plain
   version.  In every engine path (``run_path``) the flat attention kernel
   (``csrc/flat_attn.cu``) launches once a layer in every flat step;
8b. workload phase: on the same params, each of the seven workload
   presets of ``repro_torch.workloads`` (steady, bursty, shared-prefix,
   decode-heavy, preemption-storm, eviction-pressure, mixed) at full size
   (``quick=False``, seed 0), replayed in virtual time through
   ``workloads.runner`` as one path each: every request completes,
   ``tsar_matmul`` launches what the plan predicts for the replay's model
   calls, and every engine counter but ``plan_kernel`` equals the same
   trace's replay on the CPU at the reduced config (run in the phase);
   per preset TTFT p50/p99, TPOT p50/p99, output tok/s, goodput under the
   spec's SLOs (scale 1.0) and steps printed.  Then ``python -m
   repro_torch.launch.serve --arch bitnet-2b-4t --workload steady --seed 0``
   as a subprocess: exit 0 and the steady replay's counters;
8c. long context: on the same params, the main path at bitnet-2b-4t's
   whole 4096-token window (``max_len`` 4096, 4 slots, block 16, prefill
   chunk 512, so 516 tokens per flat step), four prompts of 4064, 4064,
   2048 and 256 tokens (numpy seed 0) with 16 new tokens each, under
   ``flat``, ``chunked`` and ``whole``: every request finishes, every logit
   is finite, ``tsar_matmul`` launches what the plan predicts, greedy
   tokens equal (the near-tie rule of 17b); then one flat step of 516
   tokens over the full (4, 4096) view: the card's ``max_memory_allocated``
   within 5 % of the meta count's peak (``launch.dryrun.MetaTrace``) plus
   the step's arguments; ms per prefill call and decode step per policy,
   the serving peak, and the step's meta peak and bytes accessed beside
   the card's peak printed;
9. policy phase: the same 8 requests on the same params through the
   ``chunked`` and ``whole`` policies (after ``warmup``): greedy tokens equal
   to the ``flat`` run's, launch counts equal to what the plan predicts for
   the row counts each ran (4 x 16 rows, whole prompts);
10. prefix-cache phase: 8 requests in 2 groups sharing a 96-token system
   prompt, each with a 16-48-token suffix (numpy seed 0), 16 new tokens,
   on a cold engine, a warm one (``prefix_cache=True``) and a warm one
   with a pool of 27 blocks (it preempts): equal greedy tokens, cached
   tokens skipped and fewer prefill tokens planned warm, ``kv.check()``
   and no block leaked, launch counts as the plan predicts; then a
   reduced-config step on the GPU agrees with the CPU within 1e-4;
10a. observability phase: the tight-pool run again, twice, with an
   ``EventTracer`` over a memory and a streaming sink (``build/obs/``), an
   ``IncidentMonitor`` and a ``TextfileWriter``: greedy tokens and every
   deterministic counter equal to the untraced tight run's, one structure
   fingerprint for both runs (the memory document's equal to the finalized
   stream's), ``validate``/``stream_to_perfetto``/``validate_incident``
   pass, at least one ``preemption`` incident and as many ``preempted``
   marks as preemptions, ``timeline.analyze`` counting the engine's steps
   and planned/realized tokens, the textfile parsing to the registry's
   counters; a last untraced run, so the p50 pure-decode step wall is read
   in turns (untraced, traced, traced, untraced): the tracing cost; the
   first traced document goes to ``chiprun_out/obs_tight_trace.json``;
10b. profiler annotations: ``profiler_annotations=True`` under
   ``torch.profiler`` over 4 pure-decode steps (after one the profiler's
   schedule discards): exactly 4 ``tsar_engine_step#<n>`` ranges with 210
   ``tsar_matmul`` kernels inside each; per step the device time of the
   ops inside the range beside the tracer's step ``dur``: the device-busy
   share of the model call;
10c. the reduced config's tight-pool run traced on the card and on the CPU
   (same params and requests): an identical structure fingerprint;
11. block-sparse engine phase: the same model with a seeded half of every
   projection's (256, 256) blocks zeroed (block (0, 0) always): pools for
   all 7 projections, a plan of ``tsar_sparse_padded``, both launch counts
   equal to what the plan predicts over the run's steps, and greedy tokens
   equal to engines pinned to ``tsar_mxu`` by a hand-edited plan; the two
   routes run in turns (sparse, mxu, mxu, sparse) for their step times;
12. bitlinear path phase: the seven projections of one full-width layer
   (numpy seed 0), frozen on the card by ``core.bitlinear.freeze`` dense and
   with a seeded half of their (256, 256) latent blocks zeroed (block (0, 0)
   always), ``compile_plan`` over the 14 ``FrozenBitLinear``s, then
   ``apply_frozen`` at N in {1, 4, 20} under auto, the compiled
   ``LayerPlan``s and each of the six registry names: launch counts equal
   what the resolved kernels predict, the int8 family equal to the quantized
   oracle, the float family within rtol 1e-4 / atol 2e-3 of the dense
   product, bf16 in gives bf16 out;
12a. conformance grid: the reference grid's shapes (4, 256, 256) and
   (3, 300, 200) x live-block fractions 0, 1/3, 0.95, 1 at 128 x 128 tiles,
   each case built on the card by the port's own encoders from a seeded
   CUDA generator, through ``apply_frozen(plan=<kernel>)`` for all six
   registry kernels with float32 and bf16 activations: the int8 family
   ``torch.equal`` to the quantized oracle, the float family within rtol
   1e-4 / atol 2e-3 (bf16 2e-2 / 2e-1), bf16 in gives bf16 out, each call
   launching the kernel its plan names and no other;
13. MoE phase: full-width ``deepseek-moe-16b`` (28 layers, 64 routed
   experts top-6 + 2 shared), drawn and frozen one layer at a time
   (generator seed 0), through ``flat`` twice, ``chunked`` and ``whole`` at
   its capacity factor 1.25 on the 8 requests: every request finishes, every
   logit is finite, the two ``flat`` runs give equal greedy tokens,
   ``tsar_matmul`` launches 196 x model calls (the routed experts run the
   bf16 decode and no kernel); layer 0's ``moe_forward`` on the card against
   the CPU (routing equal away from near ties within 1e-6, ``y`` within
   rtol/atol 1e-2); CUDA-event times of the expert decode and of one layer;
   the bf16 expert products, the router logits (float64 sums, and one
   float32 product beside them) and the combine of the same rows in two
   call shapes compared; runs of the first 4 requests x 8 tokens under the
   three policies at capacity 8.0 and at E / k, each pair's first
   divergence and the dropped picks printed; at E / k (no call can drop a
   pick) the three policies' greedy tokens must be equal; a reduced-config
   ``flat_step`` on the card against the CPU within 2^-8 (the bf16 roundoff
   of the expert outputs);
14. SSM phase: full-width ``mamba2-780m`` (48 layers) under ``whole``, twice
   on the 8 requests: equal greedy tokens, ``tsar_matmul`` launches 96 per
   decode step + 144 per whole prefill (``in_proj`` once more on the conv
   tail), the wrapper's pad copies counted; a reduced config's whole
   prefill + 4 decode steps on the card against the CPU within 1e-4;
15. hybrid phase: the same for full-width ``hymba-1.5b`` (32 layers, 288
   launches per decode step, 320 per whole prefill);
16. enc-dec phase: full-width ``whisper-tiny`` (4 encoder + 4 decoder
   layers, ``enc_seq`` 1500; the engine's frames are zeros, the reference's
   stub) under ``whole``, twice on the 8 requests: equal greedy tokens,
   ``tsar_matmul`` launches 64 per whole prefill (24 encoder, 40 decoder:
   self-attention, cross-attention with its K/V over the 1500 encoder rows,
   MLP) and 32 per decode step (the cross K/V come from the cache); a
   reduced config's whole prefill over numpy-seeded random frames + 4
   decode steps on the card against the CPU within 1e-4; both runs carry an
   ``EventTracer`` and give one structure fingerprint;
17. VLM phase: full-width ``llava-next-mistral-7b`` (32 layers, 2880 zero
   patch positions before every prompt, ``max_len`` 3072), drawn and
   frozen one layer at a time, under ``whole``, twice: equal greedy tokens,
   224 launches per whole prefill and per decode step (``frontend_proj`` is
   a plain fp matmul and launches none), peak device memory printed; a
   reduced config's prefill over numpy-seeded random patches + 4 decode
   steps on the card against the CPU within 1e-4;
17b. dense configs never served at full width before: ``gemma2-2b``
   (local/global windows of 4096, softcaps), ``gemma3-4b`` (5 local : 1
   global, window 1024, qk-norm), ``qwen3-32b`` (qk-norm, 64 / 8 heads)
   and ``deepseek-coder-33b`` (d 7168, 62 layers), one at a time, each
   drawn and frozen one layer at a time and freed before the next: 4
   slots, one prompt longer than the window (window + 104 tokens; 512
   without one) and 3 short ones, 8 new tokens each, under ``flat``
   (prefill chunk 512) and ``whole``: greedy tokens equal (the near-tie
   rule of the CPU engine pairs: one request may differ where the rows
   agree within 0.05 and the margin is below twice that gap), launches as
   the plan predicts; the dry-run's peak for one decode step at 4 x
   ``max_len`` within 5 % of the card's ``max_memory_allocated`` for that
   step; ms per decode step and prefill call, the serving peak, and
   ``tsar_matmul`` at the 7 projections x N = 4 summed over the layers
   beside its bound;
18. training phase: full-width ``bitnet-2b-4t`` (2.74 B latent params, two
   float32 AdamW moments) from ``train.init_state`` on the card, 3 steps of
   ``make_train_step(remat=True, accum_steps=2)`` on the synthetic stream
   (2 sequences of 1024 tokens per step): loss and gradient norm finite,
   every leaf moved, no T-SAR kernel launched; loss, step time, tokens/s
   and peak device memory printed.  The moments are dropped and the
   trained params frozen: the first 4 requests x 8 tokens through
   ``ServingEngine(packed=True)`` (``tsar_matmul`` launches as the plan
   predicts) and through ``ServingEngine(packed=False)`` on the trained
   latent params (no launch) give equal greedy tokens (the largest logit
   gap printed).  Then, on the reduced config with deterministic
   algorithms, 8 steps with a checkpoint every 2 and a simulated failure at
   step 5 under ``run_with_restarts`` end ``torch.equal`` (params and
   moments) to an uninterrupted run; and one train step of every family's
   reduced config on the card matches the CPU's loss within 1e-4 relative
   (same params, drawn on the CPU).
19a. dry-run against the card (before the phase-8 params are dropped): the
   meta-device dry-run (``repro_torch.launch.dryrun.run_cell``, 1 x 1 mesh,
   packed weights, bf16 cache) of full-width ``bitnet-2b-4t`` in two cells
   that fit one card, decode 32 x 4096 and prefill 4 x 2048, beside what
   the card holds for the same tensors (the frozen tree, the cache, the
   batch: by ``nbytes`` and by allocator deltas) and does in one step
   (peak allocated beyond what was allocated before it; the launch
   delta).  Gates: argument bytes equal by ``nbytes`` and within 1 % by the
   allocator, the kernel tally's ``tsar_matmul`` calls equal to the launch
   delta, the step's peak within 25 % of the predicted temp bytes.  After
   phase 18 the dry-run's prediction for its training cell (1024 x 2,
   latent, remat) is printed beside the measured peak (not gated).
19b. the dry-run sweep per device: every non-skipped cell of
   ``configs.cells()``, packed, on the single-pod 16 x 16 mesh, and
   ``bitnet-2b-4t``'s train, prefill and decode cells on 16 x 16 and on the
   multi-pod 2 x 16 x 16 mesh, full width on meta, each cell traced as rank
   0 of a fake world of 256 (512) ranks, one process per CPU core: every
   cell ``ok`` (a cell whose dims do not divide its axes traced as the
   last rank too, each term the larger of the two), every (fsdp) train
   cell with all-gather and reduce-scatter
   bytes, and the mesh path's layout within its limits (``sweep_outcomes``:
   the MoE train cells keep their experts on 'model' and move tokens by
   all-to-all, bitnet's decode attends over a sequence-split cache); per
   cell the bytes accessed, the collective bytes of each kind (all-to-all
   among them), the three terms and the bound, both meshes' ``report``
   tables and the sweep's wall time printed.
19c. the three examples (``examples/torch_*.py``) through ``main()`` on the
   card: quickstart's loss falls and its serving launches ``tsar_matmul``;
   every request of serve_ternary finishes, with launches and a max step
   load within its budget; train_resume completes after exactly one
   restart.
20. mesh phase: one spawned NCCL rank per card (``torch.cuda.device_count()``;
   the world size is the phase's first line: on one card every collective
   spans a world of one, and the exchange across cards is shown on the CPU
   only), on a (1, 1) mesh with one card and on (n, 1) and (1, n) meshes
   with n >= 2.  Full-width ``bitnet-2b-4t``, per mesh: the serving cells
   on the mesh (``launch.dryrun.mesh_cells``, frozen params, 4 slots x 32
   prompt tokens, 16 greedy tokens) give the tokens of the unsharded
   ``prefill`` / ``decode_step`` on the same card strictly, with 210
   ``tsar_matmul`` launches per step on every rank, prefill and decode ms
   of both printed; ``train.jit_train_step(fsdp=True)`` at phase 18's
   2 x 1024 (remat, 2 microbatches where the rows allow): loss within 1e-4
   of the plain ``loss_and_grads`` on the same batch and params, the state
   back in its placements, step time and peak device memory printed beside
   the dry-run's prediction for that mesh; on a world of one neither the
   split-KV attention nor the MoE token all-to-all runs (both paths are
   the identity there); then two
   ``make_compressed_dp_train_step`` steps (2 x 1024 rows per rank): loss
   finite.  Any failure to start NCCL fails the run.

Phase 7 also holds ``tsar_matmul`` at the enc-dec and VLM projections'
(K, M) x N in {4, 20, 1500, 3008} (the encoder's 1500 frame rows, llava's
2880 patches + a prompt) and on 1500 all-zero activation rows,
``torch.equal`` to the plain version, timed at N = 4, 20 and the family's
large N.

Each engine run and each bitlinear run is a path: every launch count is set
to 0 just before it and read just after.  Greedy tokens of two runs are
compared strictly; on a difference the script prints the first diverging
request and token with both runs' top-2 logits and margins there, then
fails (the MoE cross-policy comparisons at capacity 8.0 only print).  The card's name and power limit
are printed again before the ``{"kernels": [...]}`` line, which comes
before the last; the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
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
F64_OPS_PER_S = 67e12          # float64 on the tensor cores (DFMA alone: 34e12)

ARCH = "bitnet-2b-4t"
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = "deepseek-moe-16b", "mamba2-780m", "hymba-1.5b"
ENCDEC_ARCH, VLM_ARCH = "whisper-tiny", "llava-next-mistral-7b"
# Row counts of the family kernel phase: the SSM prefill's conv tail (3),
# decode and flat widths (4, 20), chunked rows (64), a whole prompt (128).
FAMILY_NS = (3, 4, 20, 64, 128)
# Row counts at the enc-dec and VLM shapes: decode and flat widths, the
# encoder's 1500 frame rows (whisper's enc_seq), llava's 2880 patch
# positions + a 128-token prompt.
LARGE_NS = (4, 20, 1500, 3008)
KERNEL_SOURCES = ("tsar_matmul", "tsar_sparse", "tsar_lut", "flat_attn")
# Registry kernel -> the launch counter of its hand-written kernel
# (``memory_lut`` and ``dense`` are plain PyTorch and launch none).
COUNTER_OF = {"tsar_mxu": "tsar_matmul", "tsar_lut": "tsar_lut",
              "tsar_sparse": "tsar_sparse", "tsar_sparse_padded": "tsar_sparse_padded"}
COUNTERS = ("tsar_matmul", "tsar_sparse_padded", "tsar_lut", "tsar_sparse")
# The int8 family: exact against the quantized oracle.
EXACT_KERNELS = ("tsar_mxu", "tsar_sparse", "tsar_sparse_padded")
L2_BYTES = 50 * 2**20
REPLAYS = 21
# Row counts of the kernel phases: the flat policy's decode and prefill
# widths (4, 20), the chunked policy's 4 slots x prefill_chunk 16 (64), and
# whole-prompt prefills (a ragged 77, a full 128).
MATMUL_NS = (4, 20, 64, 77, 128)
SPARSE_NS = (4, 20, 64, 128)
POLICIES = ("flat", "chunked", "whole")
# The training phase: optimizer steps, tokens per sequence, sequences per
# step, microbatches per step.
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 3, 1024, 2, 2
# Phase 19b's bitnet-2b-4t cells, swept on both production meshes.
SWEEP_BITNET_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# Phase 19a's cells: full-width bitnet decode and prefill that fit one card.
DRYRUN_CARD_CELLS = (("decode_card", 4096, 32, "decode"), ("prefill_card", 2048, 4, "prefill"))
# The mesh phase's serving cells: slots, prompt tokens, generated tokens.
MESH_SLOTS, MESH_PROMPT, MESH_TOKENS = 4, 32, 16
# Bytes allocated on the card by each ``init_frozen`` tree, by label.
FROZEN_ALLOC: dict[str, int] = {}


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


def int_mm_rows(n: int) -> int:
    """Rows ``torch._int_mm`` is given for an N-row product: at least 32, a
    multiple of 8 (its requirements on the card)."""
    return max(32, -(-n // 8) * 8)


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
    """(name, K, M) of one layer's BitLinear projections that run
    ``tsar_matmul``: attention, the MLP (gated or not) or the shared experts
    (not the routed experts), the SSM ``in_proj``/``out_proj``.  An enc-dec
    layer's are its encoder layer's (the decoder adds a cross block of the
    attention's shapes)."""
    d = cfg.d_model
    out = []
    if cfg.family != "ssm":
        qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        out += [("wq", d, qd), ("wk", d, kvd), ("wv", d, kvd), ("wo", qd, d)]
        f = cfg.d_expert * cfg.n_shared_experts if cfg.is_moe else cfg.d_ff
        if f:
            out += ([("w_gate", d, f)] if cfg.mlp_gated else []) + [("w_up", d, f),
                                                                    ("w_down", f, d)]
    if cfg.family in ("ssm", "hybrid"):
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        out += [("in_proj", d, 2 * di + 2 * n + nh), ("out_proj", di, d)]
    return out


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


def matmul_point(torch, gen, n: int, k: int, m: int, timed: bool = True) -> dict:
    """``tsar_matmul`` at one (N, K, M) point on random int8 activations and
    planes: required ``torch.equal`` to the plain version; with ``timed``,
    CUDA-graph times of the kernel, of the plain version and of
    ``torch._int_mm`` beside the bound.  Returns the row (``max_abs_err``
    and, timed, ``ms`` ``plain_ms`` ``bound_ms`` ``bound_by``
    ``library_ms``)."""
    from repro_torch.core import ternary
    from repro_torch.kernels import tsar_matmul as tm

    dev = torch.device("cuda")
    a_q = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    a_scale = torch.rand((n, 1), generator=gen, device=dev) + 0.01
    w_scale = torch.rand((m,), generator=gen, device=dev) + 0.01
    copies = max(2, min(256, math.ceil(2 * L2_BYTES / (k * m / 4)))) if timed else 1
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
    row = {"max_abs_err": err}
    if not timed:
        return row
    ms = time_graph(torch, [
        (lambda s=s, z=z: tm.tsar_matmul_packed(a_q, a_scale, s, z, w_scale))
        for s, z in planes], launches_per_replay=2 * copies)
    plain_ms = time_eager(
        torch, lambda: tm.tsar_matmul_plain(a_q, a_scale, s0, z0, w_scale))
    # Library yardstick: torch._int_mm on int8 weights decoded ahead of time
    # (4x the weight bytes of the planes), rows padded as it needs (at least
    # 32, a multiple of 8) and columns padded to a multiple of 8.
    a32 = torch.zeros((int_mm_rows(n), k), dtype=torch.int8, device=dev)
    a32[:n] = a_q
    lib_copies = max(2, min(64, math.ceil(2 * L2_BYTES / (k * m))))
    w8 = [torch.nn.functional.pad(ternary.decode_planes(s, z, k), (0, -m % 8)).contiguous()
          for s, z in planes[:lib_copies]]
    library_ms = time_graph(torch, [(lambda w=w: torch._int_mm(a32, w)) for w in w8],
                            launches_per_replay=2 * lib_copies)
    b_ms, b_by = bound(n, k, m)
    row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms})
    padded = tm.pad_for_tma(a_q, s0, z0, w_scale)
    if padded[1] is not s0:
        # The wrapper pads K or M to 16 on every call; the kernel alone runs
        # on inputs padded ahead of time.
        pads = [tm.pad_for_tma(a_q, s, z, w_scale) for s, z in planes]
        row["kernel_only_ms"] = time_graph(torch, [
            (lambda p=p: tm.tsar_matmul_packed(p[0], a_scale, p[1], p[2], p[3]))
            for p in pads], launches_per_replay=2 * copies)
    print(f"tsar_matmul N={n:3d} K={k} M={m}: equal | {ms * 1e3:.2f} us (bound "
          f"{b_ms * 1e3:.2f} us, {b_by}; {b_ms / ms:.1%} of bound)"
          + (f", of which pad copies {(ms - row['kernel_only_ms']) * 1e3:.2f} us (kernel "
             f"alone on inputs padded ahead {row['kernel_only_ms'] * 1e3:.2f} us)"
             if "kernel_only_ms" in row else "")
          + f" | plain {plain_ms * 1e3:.1f} us | _int_mm int8 {library_ms * 1e3:.2f} us",
          flush=True)
    return row


def kernel_phase(torch, cfg) -> dict:
    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tsar_matmul as tm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    max_err = 0.0
    distinct = sorted({(k, m) for _, k, m in step_shapes(cfg)})
    for n in MATMUL_NS:
        for k, m in distinct:
            rows[(n, k, m)] = matmul_point(torch, gen, n, k, m)
            max_err = max(max_err, rows[(n, k, m)]["max_abs_err"])
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


def launch_structure(torch, name: str, call, calls: int = 4, symbol: str = "") -> None:
    """torch.profiler over two cycles of ``calls`` eager calls of ``call``
    (one wrapper call of kernel ``name``, e.g. at N=4 x 2560 x 6912), one
    trace.  The second cycle must run exactly one kernel per call (the
    cluster launch), ``symbol`` (by default ``<name>_kernel``), and nothing
    else: no memset, no epilogue kernel.  The first cycle runs while device tracing starts, which can
    leave a kernel event unrecorded: its device ops are printed and must be
    a subset of the second cycle's (no memset, no other kernel name), so an
    op launched only on the first calls after a pause still fails."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for cycle in range(2):
            if cycle:
                time.sleep(0.02)       # the cycles stand 20 ms apart on the device
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
    device = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    # The cycles split at the first gap of 10 ms or more between device ops
    # (one cycle's ops lie microseconds apart); without one, the first cycle
    # left no event.
    cut = next((i for i in range(1, len(device))
                if device[i][0] - device[i - 1][0] >= 10_000.0), 0)
    first = [k for _, k in device[:cut]]
    device = [k for _, k in device[cut:]]
    symbol = symbol or f"{name}_kernel"
    kernels = [k for k in device if symbol in k]
    memsets = [k for k in device if "memset" in k.lower()]
    _require(len(kernels) == calls and len(device) == calls and not memsets,
             f"launch structure: {calls} calls ran {len(device)} device ops "
             f"({len(kernels)} {name} kernels, {len(memsets)} memsets): {device}")
    _require(len(first) <= calls and set(first) <= set(device),
             f"launch structure: the first {calls} calls ran {len(first)} device ops, "
             f"not a subset of the second cycle's: {first}")
    print(f"{name} launch structure: {calls} calls -> {len(kernels)} device kernels "
          f"({kernels[0][:60]}...), 0 memsets, no other device op; first cycle "
          f"{len(first)} ops, all {symbol}", flush=True)


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
    for n in SPARSE_NS:
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
            a32 = torch.zeros((int_mm_rows(n), k), dtype=torch.int8, device=dev)
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


def flat_live_positions(rng, n: int, vtok: int):
    """``n`` ShareGPT-like live lengths, as the benchmark cell serves: a
    prompt (lognormal, median 96, sigma 1, in [8, 1024]) plus a uniform
    share of an output (lognormal, median 256, sigma 0.8, in [16, 1023]),
    within [1, vtok)."""
    prompt = rng.lognormal(math.log(96), 1.0, n).clip(8, 1024)
    out = rng.lognormal(math.log(256), 0.8, n).clip(16, 1023)
    return (prompt + rng.random(n) * out).astype(int).clip(1, vtok - 1)


def flat_attn_bound(slot, pos, cfg, nb: int) -> tuple[float, str]:
    """Least time (ms) for one ``flat_attn`` call: the larger of the bytes
    it must move (each slot's K and V rows up to its last row's position,
    read once; float32 queries and output, 8*T*H*Dh) over HBM bandwidth and
    its float64 operations (a score and a weighted-sum FMA per key, head
    and d of each real row: 4*H*Dh*(pos+1)) over the float64 peak."""
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    real = slot < nb
    keys = {}
    for s, p in zip(slot[real].tolist(), pos[real].tolist()):
        keys[s] = max(keys.get(s, 0), p + 1)
    nbytes = sum(keys.values()) * hk * dh * 4 * 2 + 2 * len(slot) * h * dh * 4
    ops = 4 * h * dh * int((pos[real] + 1).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ops_per_call(torch, call) -> int:
    """Device operations (kernels, copies, sets) of one eager call, by
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def flat_attn_kernel_phase(torch, cfg) -> dict:
    import numpy as np

    from repro_torch.kernels import flat_attn
    from repro_torch.models import layers

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    nb, vtok, chunk = 48, 2048, 256          # the bitnet-chat-b48 cell's slots, max_len, chunk
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    ck, cv = (torch.randn((nb, vtok, hk, dh), generator=gen, device=dev) for _ in range(2))
    rows, max_err, calls = {}, 0.0, {}
    for t in (nb, nb + chunk):
        decode = flat_live_positions(rng, nb, vtok)
        if t == nb:
            slot_np, pos_np = np.arange(nb), decode
        else:
            slot_np = np.concatenate([np.arange(nb - 1), np.full(chunk, nb - 1), [nb]])
            pos_np = np.concatenate([decode[:nb - 1], 600 + np.arange(chunk), [0]])
        slot = torch.from_numpy(slot_np.astype(np.int64)).to(dev)
        pos = torch.from_numpy(pos_np.astype(np.int64)).to(dev)
        q = torch.randn((1, t, h, dh), generator=gen, device=dev)

        def kernel(q=q, slot=slot, pos=pos):
            return layers.flat_context(cfg, q, ck, cv, slot, pos, True, torch.float32)

        def plain(q=q, slot=slot, pos=pos):
            return layers._flat_context(cfg, q, ck, cv, slot, pos, True, torch.float32)

        before = flat_attn.LAUNCHES["flat_attn"]
        got = kernel()
        _require(flat_attn.LAUNCHES["flat_attn"] == before + 1,
                 f"flat_attn T={t}: the route did not launch the kernel once")
        _require(torch.equal(kernel(), got), f"flat_attn T={t}: two calls on the same inputs differ")
        real = slot < nb
        a, b = got[0, real].cpu().numpy(), plain()[0, real].cpu().numpy()
        diff = np.abs(a - b)
        past = int((diff > np.spacing(np.maximum(np.abs(a), np.abs(b)))).sum())
        _require(past == 0, f"flat_attn T={t}: {past} values past one float32 ulp of the plain "
                 f"version (max err {diff.max():.3g})")
        _require(not bool(got[0, ~real].any()), f"flat_attn T={t}: padding rows not zero")
        max_err = max(max_err, float(diff.max()))
        ms = time_graph(torch, [kernel], launches_per_replay=20)
        plain_ms = time_eager(torch, plain)
        b_ms, b_by = flat_attn_bound(slot_np, pos_np, cfg, nb)
        rows[t] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "live_keys_mean": float(pos_np[slot_np < nb].mean() + 1),
                   "plain_device_ops": device_ops_per_call(torch, plain)}
        calls[t] = kernel
        print(f"flat_attn_f64 T={t} over ({nb}, {vtok}) (mean {rows[t]['live_keys_mean']:.0f} "
              f"live keys a row): within one float32 ulp (max err {diff.max():.3g}), padding "
              f"zero, two calls equal | {ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us, {b_by}; "
              f"{b_ms / ms:.1%} of bound) | plain {plain_ms * 1e3:.1f} us in "
              f"{rows[t]['plain_device_ops']} device ops", flush=True)
    launch_structure(torch, "flat_attn", calls[nb], symbol="flat_attn_f64")
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
                if kern in EXACT_KERNELS:
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
        _require(kern not in EXACT_KERNELS
                 or torch.equal(y, want), f"bf16 through {kern} != quantized oracle")
    print("bitlinear: bf16 activations return bf16 through all six kernels", flush=True)
    return {"launches": totals}


# The reference's conformance grid (tests/test_conformance.py): (n, k, m)
# shapes, one block-aligned and one ragged; live-block fractions; tiles.
GRID_SHAPES = ((4, 256, 256), (3, 300, 200))
GRID_DENSITIES = (0.0, 1.0 / 3.0, 0.95, 1.0)
GRID_BLOCK = 128


def grid_case(torch, shape: tuple, density: float):
    """One grid case on the card: a frozen layer carrying every kernel's
    encoding (planes, LUT indices at c = 4, compacted and padded pools at
    ``GRID_BLOCK`` tiles) built with the port's own encoders, its ternary
    matrix and an activation, all from a CUDA generator seeded by the
    reference's rule."""
    from repro_torch.core import bitlinear, ternary
    from repro_torch.sparse import format as sparse_format

    n, k, m = shape
    seed = int(n * 1009 + k * 13 + m * 7 + density * 997)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = sparse_format.random_block_sparse_ternary(gen, (k, m), bk=GRID_BLOCK, bm=GRID_BLOCK,
                                                  p_zero_block=1.0 - density)
    scale = 0.25 + 1.75 * torch.rand((m,), generator=gen, device="cuda")
    idx_pos, idx_zero = ternary.pack_indices(t, 4)
    fz = bitlinear.FrozenBitLinear(
        packed=ternary.pack(t.to(torch.float32), scale), idx_pos=idx_pos, idx_zero=idx_zero,
        c=4, sparse=sparse_format.from_ternary(t, scale, bk=GRID_BLOCK, bm=GRID_BLOCK),
        padded=sparse_format.pad_from_ternary(t, scale, bk=GRID_BLOCK, bm=GRID_BLOCK),
        density=float(ternary.ternary_density(t)), block_density=None)
    x = torch.randn((n, k), generator=gen, device="cuda")
    return fz, t, x


def grid_phase(torch) -> dict:
    """The conformance grid on the card: ``GRID_SHAPES`` x ``GRID_DENSITIES``
    (:func:`grid_case`) through ``apply_frozen(plan=<kernel>)`` for all six
    registry kernels, float32 and bf16 activations.  The int8 family is
    ``torch.equal`` to ``ref.quantized_matmul_ref`` (bf16: through the same
    casts), the float family within rtol 1e-4 / atol 2e-3 of
    ``ref.ternary_matmul_ref`` (bf16: rtol 2e-2 / atol 2e-1), bf16 in gives
    bf16 out, and each call launches the kernel its plan names and no other
    (``memory_lut`` and ``dense`` none)."""
    from repro_torch.core import bitlinear
    from repro_torch.kernels import ref
    from repro_torch.plan import registry

    totals = dict.fromkeys(COUNTERS, 0)
    worst = {}
    for shape in GRID_SHAPES:
        for density in GRID_DENSITIES:
            fz, t, x = grid_case(torch, shape, density)
            _require(registry.available(fz) == registry.names(),
                     f"grid {shape} @ {density:.3g}: encodings for {registry.available(fz)}")
            for xin in (x, x.to(torch.bfloat16)):
                bf16 = xin.dtype == torch.bfloat16
                exact = ref.quantized_matmul_ref(xin, fz.packed).to(xin.dtype)
                fp = ref.ternary_matmul_ref(xin, t, fz.packed.scale)
                rtol, atol = (2e-2, 2e-1) if bf16 else (1e-4, 2e-3)
                for kern in registry.names():
                    what = f"grid {shape} @ {density:.3g} {xin.dtype} plan={kern}"
                    want = dict.fromkeys(COUNTERS, 0)
                    if kern in COUNTER_OF:
                        want[COUNTER_OF[kern]] = 1
                    zero_launch_counts()
                    y = bitlinear.apply_frozen(fz, xin, plan=kern)
                    torch.cuda.synchronize()
                    got = launch_counts()
                    _require(got == want, f"{what}: launches {got}, the plan names {want}")
                    for key in COUNTERS:
                        totals[key] += got[key]
                    _require(y.dtype == xin.dtype and y.shape == (shape[0], shape[2])
                             and bool(torch.isfinite(y).all()),
                             f"{what}: {y.dtype} {tuple(y.shape)}")
                    if kern in EXACT_KERNELS:
                        _require(torch.equal(y, exact), f"{what} != quantized oracle")
                    else:
                        err = (y.to(torch.float32) - fp).abs().max().item()
                        key = f"{kern} {'bf16' if bf16 else 'f32'}"
                        worst[key] = max(worst.get(key, 0.0), err)
                        _require(torch.allclose(y.to(torch.float32), fp, rtol=rtol, atol=atol),
                                 f"{what} != fp oracle (max err {err})")
    n_cases = len(GRID_SHAPES) * len(GRID_DENSITIES)
    print(f"grid: {n_cases} cases x 6 kernels x (float32, bf16) on the card: int8 family "
          f"equal to the quantized oracle, float family within rtol 1e-4/atol 2e-3 (bf16 "
          f"2e-2/2e-1; max errors {({k: float(f'{v:.3g}') for k, v in worst.items()})}), "
          f"every call launched the kernel its plan names and no other {totals}", flush=True)
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
    from repro_torch.kernels import flat_attn

    for d in _counter_dicts() + [flat_attn.LAUNCHES]:
        for key in d:
            d[key] = 0


def predicted_launches(engine, widths: list, whole_prefills: int = 0) -> dict:
    """Kernel launches the engine's plan predicts over model calls of these
    row counts (a flat step's width T, a rectangular step's slots x chunk, a
    whole prefill's prompt length): each projection's planned kernel at the
    call's bucket, remapped within the sparse family as
    ``models.layers._packed_linear`` does; a padded sparse kernel on a layer
    with pools is ``tsar_sparse_padded``, a planes kernel (or no plan entry)
    ``tsar_matmul``, once per stacked layer.  The routed expert stacks
    (planes (L, E, K/8, M)) run the bf16 decode and no kernel; each whole
    prefill of an SSM layer calls its ``in_proj`` once more, on the last
    W-1 rows (the conv tail); an enc-dec model's encoder layers and the
    decoder's cross ``wk``/``wv`` run once per whole prefill, on the
    ``enc_seq`` encoder rows, and never in a step."""
    from repro_torch.plan import registry

    want = dict.fromkeys(COUNTERS, 0)
    if engine.plan is None:              # latent serving (packed=False): no kernel
        return want
    cfg = engine.cfg
    tail = [cfg.ssm_conv_width - 1] * whole_prefills
    enc_rows = [cfg.enc_seq] * whole_prefills
    for name, (k, m, _c) in engine.plan.shapes.items():
        node = engine.params
        for key in name.split("/"):
            node = node[key]
        if node["sign"].ndim > 3:
            continue
        layer = {key: v[0] for key, v in node.items()}
        if name.startswith("enc_blocks/") or name.endswith(("xattn/wk", "xattn/wv")):
            rows = enc_rows
        else:
            rows = widths + (tail if name.endswith("ssm/in_proj") else [])
        for w in rows:
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


# The engine's deterministic counters: stats keys, scheduler fields and
# registry counters (the prefix-cache keys where the cache is on).
STATS_COUNTERS = ("steps", "prefill_tokens", "decode_tokens", "total_tokens",
                  "peak_kv_blocks", "max_step_tokens", "preemptions", "whole_prefills",
                  "rejections", "prefix_hit_rate", "cached_blocks", "prefix_hit_tokens",
                  "prefix_lookups", "prefix_evictions")
SCHED_COUNTERS = ("prefill_tokens_planned", "cached_tokens_skipped", "readmissions")
REGISTRY_COUNTERS = ("planned_tokens", "realized_tokens", "prefill_steps", "decode_steps",
                     "admissions")


def engine_counters(engine) -> dict:
    """Every deterministic counter of ``engine``'s run."""
    out = {k: engine.stats[k] for k in STATS_COUNTERS if k in engine.stats}
    out.update({k: getattr(engine.sched, k) for k in SCHED_COUNTERS})
    out.update({k: engine.metrics.get(k).value for k in REGISTRY_COUNTERS})
    return out


def run_path(torch, engine, reqs, label: str, serve=None) -> dict:
    """Serve ``reqs`` as one path: launch counts zeroed just before, read
    just after and held against the plan's prediction for the row counts
    of every model call the run made (and ``flat_attn``'s against one
    launch a layer in every flat step); every sampled logit row checked
    finite (and kept, for :func:`same_tokens`); every request must finish
    with its ``max_new_tokens`` tokens in ``[0, vocab)``.  The wall time of
    every pure-decode ``engine.step()`` (tracer emission included) and the
    engine's deterministic counters come back with the tokens.  ``serve``
    (a function returning the requests it served) takes the place of
    ``engine.run(reqs)``: a workload trace's replay."""
    from repro_torch.kernels import flat_attn

    widths, flat_calls, finite, rows, last, decode_wall = [], [], [], {}, {}, []
    sched = engine.sched
    plan_flat, plan_rect = sched.plan_flat, sched.plan
    sample, emit, prefill_slot = engine._sample, engine._emit_token, engine._prefill_slot

    def recording_plan_flat(*args, **kw):
        plan = plan_flat(*args, **kw)
        if hasattr(plan, "width"):
            widths.append(plan.width)
            flat_calls.append(plan.width)
        return plan

    def recording_plan(*args, **kw):
        plan = plan_rect(*args, **kw)
        if hasattr(plan, "chunk"):
            widths.append(engine.slots * plan.chunk)
        return plan

    def recording_prefill_slot(i, st):
        widths.append(len(st.prompt) + st.extra)       # a VLM's patches lead the prompt
        return prefill_slot(i, st)

    def checked_sample(logits, temps):
        finite.append(bool(torch.isfinite(logits).all().item()))
        last["logits"] = logits
        return sample(logits, temps)

    def recording_emit(i, st, tok):
        logits = last["logits"]
        rows[(st.req.uid, len(st.req.out_tokens))] = logits[i if len(logits) > 1 else 0].clone()
        return emit(i, st, tok)

    step, c_decode = engine.step, engine.metrics.get("decode_steps")

    def timed_step():
        d0, t = c_decode.value, time.perf_counter()
        out = step()
        if c_decode.value > d0:
            decode_wall.append(time.perf_counter() - t)
        return out

    sched.plan_flat, sched.plan = recording_plan_flat, recording_plan
    engine._sample, engine._emit_token = checked_sample, recording_emit
    engine._prefill_slot, engine.step = recording_prefill_slot, timed_step
    zero_launch_counts()
    t0 = time.perf_counter()
    if serve is None:
        engine.run(reqs)
    else:
        reqs = serve()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    vocab = engine.cfg.vocab_size
    _require(all(r.done and len(r.out_tokens) == r.max_new_tokens for r in reqs),
             f"{label}: not every request finished with its max_new_tokens")
    _require(all(0 <= t < vocab for r in reqs for t in r.out_tokens),
             f"{label}: a token outside [0, vocab)")
    _require(finite and all(finite), f"{label}: non-finite logits in a step")
    _require(len(widths) == engine.stats["steps"] + engine.stats["whole_prefills"],
             f"{label}: unrecorded model calls")
    want = predicted_launches(engine, widths, engine.stats["whole_prefills"])
    _require(launches == want, f"{label}: launches {launches}, the plan predicts {want}")
    flat_launches = flat_attn.LAUNCHES["flat_attn"]
    _require(flat_launches == engine.cfg.n_layers * len(flat_calls),
             f"{label}: {flat_launches} flat_attn launches over {len(flat_calls)} flat steps "
             f"of {engine.cfg.n_layers} layers")
    decode_steps = engine.metrics.get("decode_steps").value
    prefill_calls = engine.metrics.get("prefill_steps").value + engine.stats["whole_prefills"]
    n_tok = sum(len(r.out_tokens) for r in reqs)
    pct = engine.latency_percentiles()
    out = {"launches": launches, "tokens": [r.out_tokens for r in reqs], "rows": rows,
           "requests": reqs,
           "steps": engine.stats["steps"], "whole_prefills": engine.stats["whole_prefills"],
           "widths": sorted(set(widths)), "wall": wall,
           "decode_ms": engine.stats["decode_s"] / max(1, decode_steps) * 1e3,
           "prefill_ms": engine.stats["prefill_s"] / max(1, prefill_calls) * 1e3,
           "ttft_ms": pct["ttft_s"]["p50"] * 1e3, "tpot_ms": pct["tpot_s"]["p50"] * 1e3,
           "decode_step_ms": [s * 1e3 for s in decode_wall], "counters": engine_counters(engine),
           "flat_attn_launches": flat_launches}
    print(f"{label}: {len(reqs)} requests, {engine.stats['steps']} steps "
          f"({engine.metrics.get('prefill_steps').value} with prefill, "
          f"{engine.stats['whole_prefills']} whole prefills), "
          f"{engine.stats['prefill_tokens']} prompt tokens in steps, {n_tok} generated, "
          f"wall {wall:.3f} s, {n_tok / wall:.1f} generated tok/s | decode "
          f"{engine.throughput():.1f} tok/s over {decode_steps} pure-decode steps "
          f"({out['decode_ms']:.2f} ms/step) | prefill {out['prefill_ms']:.2f} ms per "
          f"call | TTFT p50 {out['ttft_ms']:.1f} ms, TPOT p50 {out['tpot_ms']:.2f} ms | "
          f"row counts {out['widths']} | launches {launches} = plan's prediction, flat_attn "
          f"{flat_launches} = {engine.cfg.n_layers} x {len(flat_calls)} flat steps", flush=True)
    return out


def divergence(torch, a: dict, b: dict, what: str) -> str | None:
    """None when two runs of the same requests gave equal greedy tokens;
    else (printed) the first diverging request and token, both runs' top-2
    logits there and their margins, and how far the two runs' logit rows
    are apart."""
    for uid, (ta, tb) in enumerate(zip(a["tokens"], b["tokens"])):
        if ta == tb:
            continue
        j = next(j for j, (x, y) in enumerate(zip(ta, tb)) if x != y)
        ra, rb = a["rows"][(uid, j)], b["rows"][(uid, j)]
        (va, ia), (vb, ib) = torch.topk(ra, 2), torch.topk(rb, 2)
        rel = ((ra - rb).abs() / rb.abs().clamp_min(1e-30)).max().item()
        msg = (f"{what}: first divergence at request {uid}, token {j}: "
               f"top-2 {ia.tolist()} {va.tolist()} (margin {(va[0] - va[1]).item():.6g}) "
               f"against {ib.tolist()} {vb.tolist()} (margin {(vb[0] - vb[1]).item():.6g}); "
               f"logit rows max abs diff {(ra - rb).abs().max().item():.6g}, max rel "
               f"diff {rel:.6g}; tokens before it equal")
        print(msg, flush=True)
        return msg
    return None


def same_tokens(torch, a: dict, b: dict, what: str) -> None:
    """Equal greedy tokens in two runs of the same requests, strictly; on a
    difference :func:`divergence` prints where, then this fails."""
    if divergence(torch, a, b, what) is not None:
        raise AssertionError(f"{what}: greedy tokens differ")


# The near-tie rule of the port's engine pairs (tests/_torch_serving.py):
# where two runs' greedy tokens first differ, their logit rows agree within
# ROW_GAP and the first run's margin between the two picks is below
# MARGIN_PER_GAP times that gap; one request per pair at most.
ROW_GAP, MARGIN_PER_GAP = 0.05, 2.0


def same_tokens_or_near_tie(torch, a: dict, b: dict, what: str) -> dict | None:
    """:func:`same_tokens` under the near-tie rule: one request may pick
    another greedy token where the runs' logit rows there agree within
    ``ROW_GAP`` and run ``a``'s margin between the two picks is below
    ``MARGIN_PER_GAP`` times their gap (its later tokens are not compared);
    anything else fails.  Returns the excuse used (request, token, margin,
    gap), or None."""
    excuses = []
    divergence(torch, a, b, what)
    for uid, (ta, tb) in enumerate(zip(a["tokens"], b["tokens"])):
        if ta == tb:
            continue
        j = next(j for j, (x, y) in enumerate(zip(ta, tb)) if x != y)
        ra, rb = a["rows"][(uid, j)], b["rows"][(uid, j)]
        gap = (ra - rb).abs().max().item()
        margin = (ra[ta[j]] - ra[tb[j]]).item()
        _require(gap <= ROW_GAP and margin < MARGIN_PER_GAP * gap,
                 f"{what}: request {uid} token {j} is not a near tie (margin {margin:.6g}, "
                 f"rows {gap:.6g} apart)")
        excuses.append({"request": uid, "token": j, "margin": margin, "gap": gap})
        print(f"{what}: request {uid} token {j} excused as a near tie (margin {margin:.6g}, "
              f"rows {gap:.6g} apart)", flush=True)
    _require(len(excuses) <= 1, f"{what}: more than one request needs the near-tie rule")
    return excuses[0] if excuses else None


def bitlinear_leaves(params) -> dict:
    """path -> frozen BitLinear dict (stacked over the layers) of every
    projection in the layer stack."""
    out = {}

    def walk(node, path):
        if "sign" in node:
            out[path] = node
            return
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)

    walk(params["blocks"], "")
    return out


def latent_leaves(tree) -> dict:
    """path -> latent BitLinear dict ``{'w'}`` of a params tree, in sorted
    path order."""
    out = {}

    def walk(node, path):
        if set(node) == {"w"}:
            out[path] = node
            return
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}" if path else k)

    walk(tree, "")
    return dict(sorted(out.items()))


def init_frozen(torch, cfg, kill_blocks: bool = False, by_block: bool = False,
                label: str = "engine"):
    """Full-width random params (generator seed 0) frozen with the engine's
    defaults.  ``kill_blocks`` first zeroes a seeded half (numpy seed 0) of
    every BitLinear stack's (256, 256) weight blocks, block (0, 0) always.
    ``by_block`` draws and freezes one layer at a time
    (``transformer.init_block``) and stacks the frozen layers, so only one
    layer's latent fp32 weights are ever resident (the MoE tree holds 16.5 B
    weights)."""
    import numpy as np

    from repro_torch.models import model_zoo, transformer
    from repro_torch.serving import freeze_params

    dev = torch.device("cuda")
    gc.collect()             # an earlier phase's engines hold reference cycles
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(0)
    if by_block:
        t_init = t_freeze = 0.0
        blocks = []
        for _ in range(cfg.n_layers):
            t0 = time.perf_counter()
            latent = transformer.init_block(cfg, gen, dev)
            torch.cuda.synchronize()
            t_init += time.perf_counter() - t0
            t0 = time.perf_counter()
            blocks.append(freeze_params(latent))
            torch.cuda.synchronize()
            t_freeze += time.perf_counter() - t0
            del latent
        params = {"blocks": transformer.stack_layers(blocks),
                  **transformer.init_head(cfg, gen, dev)}
        del blocks
    else:
        t0 = time.perf_counter()
        latents = model_zoo.init_params(cfg, gen, dev)
        if kill_blocks:
            rng = np.random.default_rng(0)
            for leaf in latent_leaves(latents["blocks"]).values():
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
    FROZEN_ALLOC[label] = torch.cuda.memory_allocated() - base
    print(f"{label}: {cfg.name} init {t_init:.2f} s, freeze {t_freeze:.2f} s"
          f"{' (one layer at a time)' if by_block else ''}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident after freeze",
          flush=True)
    return params


def dense_engine(torch, cfg, params, max_len: int = 256, **kw):
    """The dense phases' engine: 4 slots, ``prefill_chunk`` 16, ``block_size``
    16, ``max_len`` 256 on the card; ``kw`` adds options."""
    from repro_torch.serving import ServingEngine

    return ServingEngine(cfg, params, max_len=max_len, batch_slots=4, prefill_chunk=16,
                         device=torch.device("cuda"), **kw)


def engine_phase(torch, cfg, params, profile: bool = False) -> dict:
    import numpy as np

    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.serving import Request

    dev = torch.device("cuda")

    def make_engine():
        return dense_engine(torch, cfg, params)

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
    return run


def policy_phase(torch, cfg, params, flat_run: dict) -> dict:
    """The dense phase's 8 requests through the ``chunked`` and ``whole``
    policies on the same params: greedy tokens equal to the ``flat`` run's,
    and each run's launch counts equal its plan's prediction for the row
    counts it ran (slots x chunk, prompt lengths)."""
    from repro_torch.serving import Request

    runs = {"flat": flat_run}
    for policy in POLICIES[1:]:
        engine = dense_engine(torch, cfg, params, policy=policy)
        engine.warmup(seq_len=64)
        runs[policy] = run_path(torch, engine, make_requests(Request, cfg),
                                f"policy {policy}")
        same_tokens(torch, runs["flat"], runs[policy], f"policy flat vs {policy}")
    print("policies: greedy tokens equal across " + ", ".join(POLICIES) + " | " + " | ".join(
        f"{pol}: prefill {r['prefill_ms']:.2f} ms/call, decode {r['decode_ms']:.2f} ms/step, "
        f"TTFT p50 {r['ttft_ms']:.1f} ms, TPOT p50 {r['tpot_ms']:.2f} ms"
        for pol, r in runs.items()), flush=True)
    return runs


def prefix_requests(request_cls, cfg) -> list:
    """The prefix phase's traffic: 8 requests in 2 groups sharing a
    96-token system prompt (6 full blocks of 16), each with a suffix of
    16-48 tokens (numpy seed 0), 16 new tokens each."""
    import numpy as np

    rng = np.random.default_rng(0)
    systems = [rng.integers(0, cfg.vocab_size, size=96, dtype=np.int32) for _ in range(2)]
    return [request_cls(uid=i, prompt=np.concatenate([
                systems[i % 2], rng.integers(0, cfg.vocab_size, size=int(rng.integers(16, 49)),
                                             dtype=np.int32)]),
                        max_new_tokens=16) for i in range(8)]


# A pool of 27 blocks of 16 (and scratch block 0) under the prefix traffic:
# 6 preemptions with the prefix cache on.  The schedule depends on lengths
# only, so it was found on the CPU with the reduced widths and this vocab.
TIGHT_KV_BLOCKS = 28


def prefix_phase(torch, cfg, params) -> dict:
    """Shared-prefix traffic on a cold engine, a warm one (prefix cache on)
    and a warm one whose pool is tight enough to preempt: equal greedy
    tokens, fewer prefill tokens planned warm, no block leaked."""
    from repro_torch.serving import Request

    runs, engines = {}, {}
    for label, kw in (("cold", {}), ("warm", {"prefix_cache": True}),
                      ("warm, tight pool", {"prefix_cache": True,
                                            "kv_blocks": TIGHT_KV_BLOCKS})):
        engine = engines[label] = dense_engine(torch, cfg, params, **kw)
        engine.warmup(seq_len=160)
        runs[label] = run_path(torch, engine, prefix_requests(Request, cfg), f"prefix {label}")
        engine.kv.check()
        if engine.prefix is None:
            _require(engine.kv.blocks_in_use == 0, f"prefix {label}: blocks leaked")
        else:
            engine.prefix.check()
            _require(engine.kv.blocks_in_use == engine.prefix.cached_blocks,
                     f"prefix {label}: {engine.kv.blocks_in_use} blocks in use, "
                     f"{engine.prefix.cached_blocks} cached")
        if label != "cold":
            same_tokens(torch, runs["cold"], runs[label], f"prefix cold vs {label}")
    cold, warm, tight = engines.values()
    _require(warm.sched.cached_tokens_skipped > 0, "warm engine skipped no cached tokens")
    _require(warm.sched.prefill_tokens_planned < cold.sched.prefill_tokens_planned,
             f"warm planned {warm.sched.prefill_tokens_planned} prefill tokens, cold "
             f"{cold.sched.prefill_tokens_planned}")
    _require(tight.stats["preemptions"] > 0, "the tight pool did not preempt")
    print("prefix: greedy tokens equal cold / warm / warm with a tight pool | " + " | ".join(
        f"{label}: prefill tokens planned {eng.sched.prefill_tokens_planned}, cached "
        f"tokens skipped {eng.sched.cached_tokens_skipped}, hit rate "
        f"{eng.stats.get('prefix_hit_rate', 0.0):.3f}, hit tokens "
        f"{eng.stats.get('prefix_hit_tokens', 0)}, preemptions {eng.stats['preemptions']}, "
        f"steps {eng.stats['steps']}, prefill {runs[label]['prefill_ms']:.2f} ms/step, "
        f"decode {runs[label]['decode_ms']:.2f} ms/step, TTFT p50 "
        f"{runs[label]['ttft_ms']:.1f} ms" for label, eng in engines.items()), flush=True)
    return runs


OBS_DIR = ROOT / "build" / "obs"


def _p50(xs: list) -> float:
    return statistics.median(xs) if xs else float("nan")


def obs_phase(torch, cfg, params, untraced: dict) -> dict:
    """The prefix phase's tight configuration (8 shared-prefix requests, a
    27-block pool that preempts, the prefix cache on) recorded, twice: an
    ``EventTracer`` over a memory and a streaming sink, an
    ``IncidentMonitor`` and a ``TextfileWriter`` on the engine.  Recording
    must change no token and no counter of the untraced tight run; the two
    runs give one structure fingerprint, and the memory document's equals
    the finalized stream's; the document, the stream and every incident
    file validate, at least one ``preemption`` incident fires and the
    ``preempted`` marks count the engine's preemptions; the timeline counts
    the engine's steps and planned and realized tokens; the textfile parses
    to the registry's counters.  One more untraced run follows, so the
    tracing cost is read in turns (untraced, traced, traced, untraced): the
    p50 wall time of a pure-decode ``engine.step()``."""
    import shutil

    from repro_torch.obs import export, incident, timeline, trace
    from repro_torch.serving import Request

    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    traced, fps = [], []
    for i in range(2):
        stream = trace.StreamingSink(OBS_DIR / f"trace{i}.jsonl")
        tracer = trace.EventTracer(sink=trace.TeeSink(trace.MemorySink(), stream))
        monitor = incident.IncidentMonitor(str(OBS_DIR / f"incidents{i}"))
        engine = dense_engine(torch, cfg, params, prefix_cache=True, kv_blocks=TIGHT_KV_BLOCKS,
                              tracer=tracer, incidents=monitor)
        engine.warmup(seq_len=160)
        writer = export.TextfileWriter(engine.metrics, str(OBS_DIR / f"metrics{i}.prom"),
                                       interval_s=0.5).start()
        try:
            run = run_path(torch, engine, prefix_requests(Request, cfg), f"obs traced run {i + 1}")
        finally:
            writer.stop()
        label = f"obs traced run {i + 1}"
        same_tokens(torch, untraced, run, f"untraced tight run vs {label}")
        _require(run["counters"] == untraced["counters"],
                 f"{label}: counters {run['counters']} != untraced {untraced['counters']}")
        info = stream.finalize()
        doc = trace.validate(tracer.to_perfetto())
        fp = doc["otherData"]["fingerprint"]
        streamed = trace.stream_to_perfetto(info["path"])
        _require(info["fingerprint"] == fp == streamed["otherData"]["fingerprint"]
                 and len(streamed["traceEvents"]) == len(doc["traceEvents"]),
                 f"{label}: stream {info['fingerprint']} != document {fp}")
        for path in monitor.paths:
            incident.load_incident(path)
        fired = monitor.summary()["by_trigger"]
        _require(fired.get("preemption", 0) >= 1, f"{label}: no preemption incident ({fired})")
        events = tracer.events
        marks = sum(e["ph"] == "n" and e["name"] == "preempted" for e in events)
        c = run["counters"]
        _require(marks == c["preemptions"] > 0,
                 f"{label}: {marks} preempted marks, {c['preemptions']} preemptions")
        s = timeline.analyze(doc)["steps"]
        _require((s["n"], s["planned_tokens"], s["realized_tokens"])
                 == (c["steps"], c["planned_tokens"], c["realized_tokens"]),
                 f"{label}: timeline steps {s} against counters {c}")
        text = (OBS_DIR / f"metrics{i}.prom").read_text()
        samples = export.parse_samples(text)
        _require(samples == export.parse_samples(export.render(engine.metrics)) and all(
            samples[f"tsar_{k}"] == c[k] for k in ("steps", "preemptions", "admissions",
                                                   "planned_tokens", "realized_tokens")),
                 f"{label}: the textfile disagrees with the registry")
        fps.append(fp)
        stream_bytes = sum(os.path.getsize(p) for p in trace.stream_segments(info["path"]))
        traced.append({"run": run, "events": len(events), "stream_bytes": stream_bytes,
                       "segments": info["segments"], "incidents": fired,
                       "suppressed": monitor.suppressed, "writes": writer.n_writes})
        if i == 0:
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            trace.save_doc(doc, str(ROOT / "chiprun_out" / "obs_tight_trace.json"))
        del engine, tracer
    _require(fps[0] == fps[1], f"obs: traced runs fingerprint {fps[0]} and {fps[1]}")
    engine = dense_engine(torch, cfg, params, prefix_cache=True, kv_blocks=TIGHT_KV_BLOCKS)
    engine.warmup(seq_len=160)
    after = run_path(torch, engine, prefix_requests(Request, cfg), "obs untraced run")
    same_tokens(torch, untraced, after, "untraced tight runs")
    plain = [_p50(r["decode_step_ms"]) for r in (untraced, after)]
    rec = [_p50(t["run"]["decode_step_ms"]) for t in traced]
    cost = statistics.mean(rec) - statistics.mean(plain)
    t0 = traced[0]
    print(f"obs: tight run traced twice, tokens and {len(untraced['counters'])} counters equal "
          f"to the untraced run's, one fingerprint {fps[0][:23]}... (memory = stream), "
          f"{t0['events']} events, stream {t0['stream_bytes']} bytes in {t0['segments']} "
          f"segment(s), incidents {t0['incidents']} ({t0['suppressed']} debounced), "
          f"{t0['writes']} textfile writes | p50 pure-decode step in turns: untraced "
          f"{plain[0]:.2f}, traced {rec[0]:.2f}, traced {rec[1]:.2f}, untraced {plain[1]:.2f} "
          f"ms -> tracing cost {cost:+.2f} ms/step ({cost / statistics.mean(plain):+.1%}) over "
          f"{len(t0['run']['decode_step_ms'])} decode steps per run | {gpu_line()}", flush=True)
    return {"fingerprint": fps[0], "cost_ms": cost}


def annotation_phase(torch, cfg, params) -> dict:
    """``profiler_annotations=True`` under ``torch.profiler`` over 4
    pure-decode steps (4 slots busy, as :func:`profile_decode` sets them
    up), after one step that the profiler's schedule records and discards
    (device tracing starts there): exactly 4 ``tsar_engine_step#<n>``
    ranges, 4 x 210 ``tsar_matmul`` kernels in the window and 210 launched
    inside each range.  Per step: the range's host time, the device time of
    the ops launched inside it, and the tracer's step ``dur`` (the same
    model call), so the device-busy share of the call comes from one run."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.obs import trace
    from repro_torch.serving import Request

    tracer = trace.EventTracer()
    engine = dense_engine(torch, cfg, params, tracer=tracer, profiler_annotations=True)
    for i in range(4):
        engine.submit(Request(uid=i, prompt=np.arange(8, dtype=np.int32) + i,
                              max_new_tokens=32))
    while any(s is None or s.prefilling for s in engine._slots):
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    held = {}

    def keep(prof):
        held["events"] = list(prof.events())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=4, repeat=1),
                 on_trace_ready=keep) as prof:
        for _ in range(5):
            engine.step()
            prof.step()
    _require("events" in held, "annotations: the profiler's schedule saved no trace")
    cuda = torch.autograd.DeviceType.CUDA
    events = held["events"]
    host = [e for e in events if e.device_type != cuda]
    ranges = sorted((e for e in host if e.name.startswith(trace.STEP_RANGE + "#")),
                    key=lambda e: e.time_range.start)
    marks = (trace.STEP_RANGE, "ProfilerStep")    # the ranges' own device spans
    ops = [e for e in events if e.device_type == cuda and not e.name.startswith(marks)]
    kernels = [e for e in ops if "tsar_matmul_kernel" in e.name]
    per_step = 7 * cfg.n_layers
    _require(len(ranges) == 4, f"annotations: {len(ranges)} {trace.STEP_RANGE} ranges, not 4: "
             f"{[e.name for e in ranges]}")
    _require(len(kernels) == 4 * per_step,
             f"annotations: {len(kernels)} tsar_matmul kernels, not 4 x {per_step}")
    records = {e["args"]["step"]: e for e in tracer.events if e["ph"] == "X"}
    # A device op belongs to the range whose host span holds the runtime call
    # that launched it (cudaLaunchKernel, cudaMemcpyAsync, ...: the same
    # correlation id), not the range that holds its own timestamp: within one
    # window the device clock drifted up to 17 ms from the host's (torch
    # 2.11), so by timestamps a step's kernels fell into its neighbour.
    runtime = {e.id: e for e in host if e.name.startswith("cu")}
    _require(all(e.id in runtime for e in kernels),
             "annotations: a tsar_matmul kernel has no runtime call of its correlation id")
    rows = []
    for r in ranges:
        n = int(r.name.split("#")[1])
        inside = [e for e in ops if e.id in runtime
                  and r.time_range.start <= runtime[e.id].time_range.start < r.time_range.end]
        k = sum("tsar_matmul_kernel" in e.name for e in inside)
        _require(k == per_step, f"annotations: step {n} range launched {k} tsar_matmul kernels")
        _require(n in records and records[n]["args"]["prefill_tokens"] == 0,
                 f"annotations: step {n} has no pure-decode step record")
        busy = sum(e.time_range.elapsed_us() for e in inside)
        rows.append((n, r.time_range.elapsed_us(), busy, records[n]["dur"], len(inside)))
    for n, host_us, busy, d, n_ops in rows:
        print(f"  annotated step {n}: range {host_us / 1e3:.3f} ms host, device ops launched "
              f"inside {busy / 1e3:.3f} ms ({n_ops} ops, {per_step} tsar_matmul), tracer dur "
              f"{d / 1e3:.3f} ms -> device-busy share {busy / d:.1%}", flush=True)
    share = sum(b for _, _, b, _, _ in rows) / sum(d for _, _, _, d, _ in rows)
    print(f"annotations: 4 {trace.STEP_RANGE} ranges, {len(kernels)} tsar_matmul kernels "
          f"(4 x {per_step}) | device-busy share of the annotated model calls {share:.1%} "
          f"(profiler on: its host cost is in the dur) | {gpu_line()}", flush=True)
    return {"busy_share": share}


def obs_agreement(torch, cfg_full) -> None:
    """Reduced config: the tight prefix traffic traced on the card and on
    the CPU, same params and requests: an identical structure fingerprint."""
    from repro_torch.models import model_zoo
    from repro_torch.obs import trace
    from repro_torch.serving import Request, ServingEngine, freeze_params

    cfg = cfg_full.reduced()
    params_cpu = freeze_params(model_zoo.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        tracer = trace.EventTracer()
        engine = ServingEngine(cfg, _to(torch, params_cpu, dev), max_len=256, batch_slots=4,
                               prefill_chunk=16, prefix_cache=True, kv_blocks=TIGHT_KV_BLOCKS,
                               tracer=tracer, device=torch.device(dev))
        reqs = engine.run(prefix_requests(Request, cfg))
        out[dev] = (trace.structure_fingerprint(tracer.events), len(tracer.events),
                    engine.stats["preemptions"], [r.out_tokens for r in reqs])
    cpu, card = out["cpu"], out["cuda"]
    _require(card[2] > 0, f"reduced {cfg.name}: the tight pool did not preempt")
    _require(card[0] == cpu[0], f"reduced {cfg.name} traced run: card fingerprint {card[0]} "
             f"({card[1]} events) != CPU {cpu[0]} ({cpu[1]} events); tokens equal: "
             f"{card[3] == cpu[3]}")
    print(f"reduced {cfg.name} tight prefix run traced on the card and the CPU: one structure "
          f"fingerprint {card[0][:23]}... ({card[1]} events, {card[2]} preemptions)", flush=True)


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
        same_tokens(torch, run, check, f"sparse checkpoint, the main run vs the {label} plan")
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


def cpu_agreement(torch, cfg_full, tol: float = 1e-4) -> None:
    """Reduced config: one flat step on the GPU (kernel) and on the CPU
    (plain path) with the same frozen weights agree within ``tol``."""
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
    diff = (outs["cuda"] - outs["cpu"]).abs().max().item()
    print(f"reduced {cfg.name} flat_step GPU vs CPU: max abs diff {diff:.3g} "
          f"(tol {tol:.3g})", flush=True)
    _require(torch.allclose(outs["cuda"], outs["cpu"], rtol=tol, atol=tol),
             f"reduced {cfg.name} flat_step on the GPU disagrees with the CPU")


def whole_agreement(torch, cfg_full, tol: float = 1e-4) -> None:
    """Reduced config: one whole prefill of 16 tokens and 4 decode steps
    (fixed tokens) on the GPU and on the CPU with the same frozen weights
    give logits within ``tol``.  An enc-dec prefill encodes, and a VLM
    prefill projects, numpy-seeded random frames or patches (the engine's
    are zeros), so the encoder, the cross-attention and ``frontend_proj``
    do real work; a VLM's decode positions follow its patches."""
    import numpy as np

    from repro_torch.models import model_zoo
    from repro_torch.serving import freeze_params

    cfg = cfg_full.reduced()
    params_cpu = freeze_params(model_zoo.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    toks = torch.arange(40).reshape(2, 20) * 37 % cfg.vocab_size
    rng = np.random.default_rng(0)
    stubs = {}
    if cfg.family == "encdec":
        stubs["frames"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        stubs["patches"] = rng.standard_normal((2, cfg.frontend_seq, cfg.frontend_dim),
                                               dtype=np.float32)
    extra = cfg.frontend_seq if cfg.family == "vlm" else 0
    outs = {}
    for dev in ("cpu", "cuda"):
        params = _to(torch, params_cpu, dev)
        cache = model_zoo.init_cache(cfg, 2, 32 + extra, device=dev)
        batch = {"tokens": toks[:, :16].to(dev),
                 **{k: torch.from_numpy(v).to(dev) for k, v in stubs.items()}}
        logits, cache = model_zoo.prefill(cfg, params, batch, cache)
        seq = [logits[:, -1]]
        for t in range(16, 20):
            lg, cache = model_zoo.decode_step(cfg, params, toks[:, t:t + 1].to(dev), cache,
                                              t + extra)
            seq.append(lg[:, 0])
        outs[dev] = torch.stack(seq).cpu()
    diff = (outs["cuda"] - outs["cpu"]).abs().max().item()
    what = "".join(f" over random {k}" for k in stubs)
    print(f"reduced {cfg.name} prefill{what} + 4 decode steps GPU vs CPU: max abs diff "
          f"{diff:.3g} (tol {tol:.3g})", flush=True)
    _require(torch.allclose(outs["cuda"], outs["cpu"], rtol=tol, atol=tol),
             f"reduced {cfg.name} prefill/decode on the GPU disagrees with the CPU")


def family_kernel_phase(torch, cfgs: list) -> dict:
    """``tsar_matmul`` at every (K, M) of the MoE, SSM and hybrid models'
    kernel projections x ``FAMILY_NS`` rows, ``torch.equal`` to the plain
    version, timed at N = 4 and 20 (with the pad copies apart where the
    wrapper pads); per model, one decode step's sum at N = 4."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = {}
    for cfg in cfgs:
        for k, m in sorted({(k, m) for _, k, m in step_shapes(cfg)}):
            if (FAMILY_NS[0], k, m) in rows:
                continue
            for n in FAMILY_NS:
                rows[(n, k, m)] = matmul_point(torch, gen, n, k, m, timed=n in (4, 20))
            print(f"tsar_matmul K={k} M={m} ({cfg.name}): equal to the plain version at "
                  f"N in {FAMILY_NS}", flush=True)
    for cfg in cfgs:
        shapes = step_shapes(cfg)
        tot = {key: sum(rows[(4, k, m)][key] for _, k, m in shapes) * cfg.n_layers
               for key in ("ms", "bound_ms", "library_ms", "plain_ms")}
        pads = [name for name, k, m in shapes if "kernel_only_ms" in rows[(4, k, m)]]
        print(f"{cfg.name}: one N=4 decode step's {len(shapes) * cfg.n_layers} tsar_matmul "
              f"launches {tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms, _int_mm "
              f"{tot['library_ms']:.4f} ms, plain {tot['plain_ms']:.2f} ms); projections "
              f"the wrapper pads on every call: {pads or 'none'}", flush=True)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows.values())}


def moe_layer_agreement(torch, cfg, params) -> None:
    """Layer 0's ``moe_forward`` on the card and on the CPU on numpy-seeded
    inputs (2 x 20 tokens): the same routing indices except for tokens
    whose gates around the k-th are within 1e-6 (counted), ``y`` within
    rtol/atol 1e-2 where the routing agrees."""
    import numpy as np

    from repro_torch.models import moe, transformer

    p_gpu = transformer.layer_slice(params["blocks"], 0)["moe"]
    p_cpu = _to(torch, p_gpu, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32))
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        xd = x.to(dev)
        r = moe._route(cfg, p, xd)
        y, aux = moe.moe_forward(cfg, p, xd)
        out[dev] = ({k: v.cpu() for k, v in r.items()}, y.cpu(), float(aux))
    (rg, yg, ag), (rc, yc, ac) = out["cuda"], out["cpu"]
    k = cfg.moe_top_k
    g = torch.sort(rc["gates"], dim=-1, descending=True).values[..., :k + 1]
    near = (g[..., :-1] - g[..., 1:]).abs().min(dim=-1).values <= 1e-6     # (B, S)
    same = (rg["topi"] == rc["topi"]).all(dim=-1)
    _require(bool((same | near).all()), "moe_forward routing differs on the card away "
             "from a near tie")
    rows = same.all(dim=-1)             # batch rows whose every token routes alike
    err = (yg - yc).abs().max().item()
    _require(torch.allclose(yg[rows], yc[rows], rtol=1e-2, atol=1e-2),
             f"moe_forward y on the card != CPU (max abs diff {err})")
    dispatch_equal = torch.equal(rg["dispatch"], rc["dispatch"])
    print(f"moe: layer-0 moe_forward card vs CPU on 2 x 20 tokens: routing equal on "
          f"{int(same.sum())}/{same.numel()} tokens, {int(near.sum())} near ties "
          f"(<= 1e-6), dispatch equal {dispatch_equal}, y max abs diff {err:.3g} "
          f"(rtol/atol 1e-2), aux {ag:.6f} vs {ac:.6f}", flush=True)


def moe_phase(torch, cfg) -> dict:
    """Full-width MoE serving: flat twice, chunked, whole at the config's
    capacity, then cross-policy measurements (printed, not gated)."""
    import dataclasses

    from repro_torch.models import layers, moe, transformer
    from repro_torch.serving import Request

    params = init_frozen(torch, cfg, by_block=True, label="moe")
    leaves = bitlinear_leaves(params)
    routed = sorted(path for path, leaf in leaves.items() if leaf["sign"].ndim == 4)
    _require(routed == ["moe/w_down", "moe/w_gate", "moe/w_up"], f"routed stacks {routed}")
    _require(not any("sp_sign" in leaf for leaf in leaves.values()),
             "absmean weights froze sparse pools")
    per_call = len(step_shapes(cfg)) * cfg.n_layers
    runs, engines = {}, {}
    for label, kw in (("flat", {}), ("flat again", {"profile_density": False}),
                      ("chunked", {"policy": "chunked", "profile_density": False}),
                      ("whole", {"policy": "whole", "profile_density": False})):
        t0 = time.perf_counter()
        engine = engines[label] = dense_engine(torch, cfg, params, **kw)
        t_init = time.perf_counter() - t0
        if label == "flat":
            kernels = {lp.kernel for by_n in engine.plan.layers.values()
                       for lp in by_n.values()}
            _require(kernels <= {"tsar_mxu", "tsar_lut"}, f"moe plan names {kernels}")
            print(f"moe: engine init {t_init:.2f} s, plan kernels {sorted(kernels)} over "
                  f"{len(engine.plan.layers)} layers (routed stacks included, served by "
                  f"the bf16 decode)", flush=True)
        run = runs[label] = run_path(torch, engine, make_requests(Request, cfg), f"moe {label}")
        calls = run["steps"] + run["whole_prefills"]
        _require(run["launches"]["tsar_matmul"] == per_call * calls,
                 f"moe {label}: tsar_matmul launched {run['launches']['tsar_matmul']} times, "
                 f"expected {per_call} x {calls} model calls")
    same_tokens(torch, runs["flat"], runs["flat again"], "moe flat vs flat again")
    for pol in ("chunked", "whole"):
        divergence(torch, runs["flat"], runs[pol], f"moe capacity {cfg.capacity_factor} "
                   f"flat vs {pol} (not gated)")
    moe_layer_agreement(torch, cfg, params)

    # Device time of the routed-expert decode and of one layer's MoE at the
    # decode and flat-prefill widths (CUDA events).
    p0 = transformer.layer_slice(params["blocks"], 0)["moe"]
    dec_ms = time_eager(torch, lambda: [moe._decode_planes(p0[n]["sign"], p0[n]["zero"],
                                                           p0[n]["scale"])
                                        for n in ("w_gate", "w_up", "w_down")])
    gen = torch.Generator(device="cuda").manual_seed(6)
    layer_ms = {t: time_eager(torch, lambda t=t: moe.moe_forward(
        cfg, p0, torch.randn((1, t, cfg.d_model), generator=gen, device="cuda")))
        for t in (4, 20)}
    # Do the MoE's products round the same rows alike in the call shapes the
    # policies give them?  Rows alone against inside a larger call: the
    # bf16 expert products (3 slots of 1 batch row, inside 15 slots and
    # inside 4 batch rows), the router logits (4 rows, inside 20, 64 and 128;
    # as the router computes them, float64 sums rounded once, and as one
    # float32 product, the spelling before) and the bf16 combine (3 slots,
    # inside 15, the rest zero; its expert outputs from the 1-row calls).
    def differ(a, b) -> str:
        return f"{int((a != b).sum())} of {a.numel()}"

    xe = torch.randn((4, cfg.n_experts, 15, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    full = moe._expert_ffn(p0, xe)
    narrow = moe._expert_ffn(p0, xe[:1, :, :3].contiguous())
    one_row = moe._expert_ffn(p0, xe[:1])
    wide = one_row[:, :, :3]
    x128 = torch.randn((1, 128, cfg.d_model), generator=gen, device="cuda")
    r4 = moe._router_logits(p0["router"], x128[:, :4].contiguous())
    f4 = layers.linear(p0["router"], x128[:, :4].contiguous())
    comb = torch.rand((1, 4, cfg.n_experts, 15), generator=gen, device="cuda").to(torch.bfloat16)
    comb[..., 3:] = 0
    c_wide = moe._bf16_einsum("bsec,becd->bsd", comb, one_row)
    c_narrow = moe._bf16_einsum("bsec,becd->bsd", comb[..., :3].contiguous(), narrow)
    print("moe: the same rows in two call shapes, elements that differ: bf16 expert "
          f"outputs 3 slots vs 15 {differ(narrow, wide)}, 1 batch row vs 4 "
          f"{differ(narrow, full[:1, :, :3])}; router logits 4 rows vs "
          + ", ".join(f"{t} {differ(r4, moe._router_logits(p0['router'], x128[:, :t])[:, :4])}"
                      for t in (20, 64, 128))
          + " (as one float32 product: "
          + ", ".join(f"{t} {differ(f4, layers.linear(p0['router'], x128[:, :t])[:, :4])}"
                      for t in (20, 64, 128)) + ")"
          + f"; bf16 combine 3 slots vs 15 {differ(c_narrow, c_wide)}", flush=True)
    flat = runs["flat"]
    print(f"moe: expert decode (3 stacks, 553.6 M weights -> bf16) {dec_ms:.3f} ms per layer, "
          f"{dec_ms * cfg.n_layers:.2f} ms per model call | one layer's moe_forward "
          f"{layer_ms[4]:.3f} ms at 4 tokens, {layer_ms[20]:.3f} ms at 20 | flat decode "
          f"{flat['decode_ms']:.2f} ms/step, prefill {flat['prefill_ms']:.2f} ms/step",
          flush=True)

    # The first 4 requests, 8 new tokens, under the three policies at
    # capacity 8.0 (dropless at the reduced widths: C = 4 S there) and at
    # E / k (C >= S: no call can drop at any width; 8.0 gives C = 0.75 S
    # here); the first divergence of each pair and the (token, expert)
    # picks dropped are printed.  At E / k the greedy tokens must be equal
    # across the policies (the router and expert sums are float64, rounded
    # once: the same bits in every call layout); at 8.0 a policy's calls
    # can drop other picks, so there they are printed, not gated.
    route = moe._route
    dropped = {"n": 0}

    def counting_route(c, p, x, *rest):
        r = route(c, p, x, *rest)
        kept = int(r["dispatch"].to(torch.float32).sum().item())
        dropped["n"] += x.shape[0] * x.shape[1] * c.moe_top_k - kept
        return r

    same = {}
    moe._route = counting_route
    try:
        for cf in (8.0, cfg.n_experts / cfg.moe_top_k):
            cf_cfg = dataclasses.replace(cfg, capacity_factor=cf)
            drop, drops = {}, {}
            for pol in POLICIES:
                reqs = make_requests(Request, cfg)[:4]
                for r in reqs:
                    r.max_new_tokens = 8
                engine = dense_engine(torch, cf_cfg, params, policy=pol, profile_density=False)
                dropped["n"] = 0
                drop[pol] = run_path(torch, engine, reqs, f"moe capacity {cf:.4g} {pol}")
                drops[pol] = dropped["n"]
            gated = cf == cfg.n_experts / cfg.moe_top_k
            same[cf] = {f"{a} vs {b}": divergence(
                torch, drop[a], drop[b],
                f"moe capacity {cf:.4g} {a} vs {b}{'' if gated else ' (not gated)'}") is None
                for a, b in (("flat", "chunked"), ("flat", "whole"), ("chunked", "whole"))}
            print(f"moe capacity {cf:.4g}: cross-policy greedy tokens equal {same[cf]}; "
                  f"(token, expert) picks dropped, padding rows included: {drops}",
                  flush=True)
            if gated:
                _require(not any(drops.values()), f"moe capacity {cf:.4g} dropped picks")
                _require(all(same[cf].values()),
                         f"moe capacity {cf:.4g} (dropless): greedy tokens differ across "
                         "the policies")
    finally:
        moe._route = route
    # The expert outputs are rounded to bf16 (relative roundoff 2^-8); the
    # card and the CPU sum their float32 products in different orders, so
    # one can round a bf16 ulp apart: the logits are held to 2^-8.
    cpu_agreement(torch, cfg, tol=2.0 ** -8)
    return {"runs": runs, "cross_policy_same": same}


def workload_phase(torch, cfg, params) -> dict:
    """8b: each workload preset (``repro_torch.workloads``) at full size
    (``quick=False``, seed 0) replayed in virtual time on the card through
    ``workloads.runner`` on the full-width frozen ``params``, as one path
    each: every request completes, ``tsar_matmul`` launches what the plan
    predicts for the replay's model calls, and the engine's counters equal
    those of the same trace replayed on the CPU at the reduced config
    (every key but ``plan_kernel``: the scheduler sees lengths and the
    spec's engine hints, never the model's width).  Then the serve CLI
    once, as a subprocess: ``--workload steady --seed 0`` exits 0 and
    prints the in-process steady replay's counters."""
    from repro_torch.models import model_zoo
    from repro_torch.serving import freeze_params
    from repro_torch.workloads import WORKLOADS, generate, metrics, preset, runner

    small = cfg.reduced()
    small_params = freeze_params(model_zoo.init_params(small, torch.Generator().manual_seed(0),
                                                       "cpu"))
    out = {}
    for name in WORKLOADS:
        spec = preset(name, quick=False, seed=0)
        trace = generate(spec)
        want = runner.run_workload(spec, small, small_params, trace=trace,
                                   device="cpu")[0]["counters"]
        engine = runner.build_engine(spec, cfg, params, device=torch.device("cuda"))
        engine.warmup(seq_len=max(len(t.prompt) + t.max_new_tokens for t in trace.requests))
        wall = []

        def serve():
            reqs, w = runner.replay(engine, trace, warmup=False)
            wall.append(w)
            return reqs

        run = run_path(torch, engine, None, f"workload {name}", serve=serve)
        got = metrics.engine_counters(engine)
        kernel = got.pop("plan_kernel")
        want.pop("plan_kernel")
        _require(got == want, f"workload {name}: counters on the card {got}, reduced on the "
                 f"CPU {want}")
        m = metrics.latency_metrics(run["requests"], trace, wall[0])
        t, p, g = m["ttft_s"], m["tpot_s"], m["goodput"]
        out[name] = {"counters": got, "metrics": m, "launches": run["launches"]}
        print(f"workload {name} ({trace.n_requests} requests, "
              f"{trace.fingerprint()[:18]}...): TTFT p50/p99 {t['p50'] * 1e3:.1f}/"
              f"{t['p99'] * 1e3:.1f} ms | TPOT p50/p99 {p['p50'] * 1e3:.2f}/{p['p99'] * 1e3:.2f} "
              f"ms | {m['output_tok_s']:.1f} out tok/s | goodput {g['good']}/{g['total']} at SLO "
              f"scale 1.0 (ttft {spec.slo.get('ttft_s')} s, tpot {spec.slo.get('tpot_s')} s: "
              f"the spec's) | steps {got['steps']}, preemptions {got['preemptions']}, "
              f"prefix hit rate {got.get('prefix_hit_rate', 0.0):.3f} | {len(got)} counters "
              f"equal to the reduced CPU replay's | plan {kernel} | {gpu_line()}", flush=True)
        del engine, run
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", cfg.name,
                           "--workload", "steady", "--seed", "0"], cwd=ROOT, timeout=600,
                          env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
                          text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("counters:")]
    _require(proc.returncode == 0 and len(lines) == 1,
             f"serve --workload steady: exit {proc.returncode}\n{proc.stdout[-2000:]}"
             f"\n{proc.stderr[-2000:]}")
    c = out["steady"]["counters"]
    _require(lines[0].startswith(
        f"counters: steps={c['steps']} preemptions={c['preemptions']} "
        f"prefill_tokens={c['prefill_tokens']} prefix_hit_rate=0.000 "),
        f"serve --workload steady: {lines[0]} against the replay's {c}")
    print(f"serve CLI --workload steady --seed 0 (subprocess): exit 0 | "
          f"{next(ln for ln in proc.stdout.splitlines() if ln.startswith('TTFT'))} | "
          f"{lines[0]}", flush=True)
    return out


# Phase 8c: bitnet-2b-4t at its whole published context (4096 tokens, the
# BitNet b1.58 2B4T model card), 4 slots, block 16, a Sarathi-sized prefill
# chunk of 512 (a flat step of 516 tokens); two prompts filling the window,
# one half of it and a short turn, 16 new tokens each.
LONG_MAX_LEN, LONG_SLOTS, LONG_CHUNK = 4096, 4, 512
LONG_PROMPTS, LONG_NEW = (4064, 4064, 2048, 256), 16


def long_requests(request_cls, cfg) -> list:
    """Phase 8c's traffic: prompts of ``LONG_PROMPTS`` tokens (numpy seed
    0), ``LONG_NEW`` new tokens each."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [request_cls(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32),
                        max_new_tokens=LONG_NEW) for i, n in enumerate(LONG_PROMPTS)]


def long_context_phase(torch, cfg, params) -> dict:
    """8c: :func:`long_requests` through ``ServingEngine`` (``max_len``
    4096, 4 slots, block 16, prefill chunk 512) under every policy, each as
    one path (:func:`run_path`: requests finish, logits finite, launches as
    the plan predicts); greedy tokens equal to the ``flat`` run's under the
    near-tie rule; then :func:`long_flat_step`."""
    from repro_torch.serving import Request, ServingEngine

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for policy in POLICIES:
        engine = ServingEngine(cfg, params, max_len=LONG_MAX_LEN, batch_slots=LONG_SLOTS,
                               prefill_chunk=LONG_CHUNK, block_size=16, policy=policy,
                               device=dev)
        engine.warmup(seq_len=64)
        runs[policy] = run_path(torch, engine, long_requests(Request, cfg), f"long {policy}")
        del engine
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    excuses = {pol: same_tokens_or_near_tie(torch, runs["flat"], runs[pol],
                                            f"long flat vs {pol}") for pol in POLICIES[1:]}
    step = long_flat_step(torch, cfg, params)
    print(f"long context (8c): {cfg.name}, max_len {LONG_MAX_LEN}, {LONG_SLOTS} slots, chunk "
          f"{LONG_CHUNK}, prompts {list(LONG_PROMPTS)}, {LONG_NEW} new tokens | " + " | ".join(
              f"{pol}: prefill {r['prefill_ms']:.2f} ms/call, decode {r['decode_ms']:.2f} "
              f"ms/step, {r['steps']} steps ({r['whole_prefills']} whole prefills), TTFT p50 "
              f"{r['ttft_ms']:.1f} ms, TPOT p50 {r['tpot_ms']:.2f} ms"
              for pol, r in runs.items())
          + f" | tokens {'equal' if not any(excuses.values()) else f'equal but {excuses}'} | "
          f"serving peak {serve_peak:.2f} GiB | {gpu_line()}", flush=True)
    return {"runs": runs, "peak_gib": serve_peak, "near_tie": excuses, "step": step}


def long_flat_step(torch, cfg, params) -> dict:
    """One flat step of ``LONG_CHUNK + LONG_SLOTS`` rows (slot 0's last 512
    positions, one decode token in each other slot, one padding row, as the
    engine fills its token budget) over the full
    (4, 4096) float32 view, as ``model_zoo.flat_step`` runs it in the
    engine: the card's ``max_memory_allocated`` for the step (the params,
    its arguments and its peak) within 5 % of ``dryrun.MetaTrace``'s count
    of the same step on meta (its peak of live bytes plus the arguments);
    its logits finite and its ``tsar_matmul`` launches the meta tally's."""
    import numpy as np

    from repro_torch.kernels import tally
    from repro_torch.launch import dryrun
    from repro_torch.models import model_zoo
    from repro_torch.serving import freeze_params

    t = LONG_CHUNK + LONG_SLOTS
    rng = np.random.default_rng(3)
    host = {"tokens": rng.integers(0, cfg.vocab_size, size=t).astype(np.int32),
            "slot": np.repeat(np.arange(LONG_SLOTS + 1),
                              [LONG_CHUNK] + [1] * (LONG_SLOTS - 1) + [1]),
            "pos": np.concatenate([np.arange(LONG_MAX_LEN - LONG_CHUNK, LONG_MAX_LEN),
                                   np.array(LONG_PROMPTS[1:]) - 1, [0]]),
            "emit_row": np.arange(LONG_CHUNK - 1, t - 1)}
    shape = (cfg.n_layers, LONG_SLOTS, LONG_MAX_LEN, cfg.n_kv_heads, cfg.head_dim)

    def step_args(dev):
        ints = {k: torch.from_numpy(v).to(dev, torch.int32 if k == "tokens" else torch.long)
                for k, v in host.items()}
        cache = {n: torch.zeros(shape, device=dev) for n in ("k", "v")}
        return ints["tokens"], ints["slot"], ints["pos"], cache, ints["emit_row"]

    meta_params = freeze_params(model_zoo.param_specs(cfg))
    meta_args = step_args(torch.device("meta"))
    trace = dryrun.MetaTrace(dryrun._storage_keys((meta_params,) + meta_args))
    del tally.TALLY[:]
    try:
        with trace:
            model_zoo.flat_step(cfg, meta_params, *meta_args)
        tallied = tally.counts().get("tsar_matmul", 0)
    finally:
        del tally.TALLY[:]
    pred = dryrun._nbytes((meta_params,) + meta_args) + trace.peak
    del meta_params, meta_args

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    other = torch.cuda.memory_allocated() - FROZEN_ALLOC["engine"]
    args = step_args(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model_zoo.flat_step(cfg, params, *args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    card = torch.cuda.max_memory_allocated() - other
    launches = launch_counts()["tsar_matmul"]
    _require(bool(torch.isfinite(logits).all()), "long flat step: logits")
    del logits, cache, args
    gap = abs(card - pred) / pred
    print(f"long flat step (8c): T {t} over a ({LONG_SLOTS}, {LONG_MAX_LEN}) float32 view, "
          f"{ms:.2f} ms (host clock, one cold call) | meta count: peak {trace.peak / 2**30:.3f} "
          f"GiB beyond the arguments, bytes accessed {trace.bytes_accessed / 1e9:.1f} GB, with "
          f"the arguments {pred / 2**30:.3f} GiB | card {card / 2**30:.3f} GiB "
          f"({100 * gap:.2f} % off) | {launches} tsar_matmul launches = tally | {gpu_line()}",
          flush=True)
    _require(launches == tallied, f"long flat step: {launches} launches, tally {tallied}")
    _require(gap <= 0.05, f"long flat step: card peak {card} B against {pred:.0f} B "
             f"counted ({100 * gap:.2f} %)")
    return {"ms": ms, "meta_peak": trace.peak, "bytes_accessed": trace.bytes_accessed,
            "pred": pred, "card": card}


# Phase 17b's configs, never served at full width before: windowed
# attention with softcaps, 5:1 local:global with qk-norm, qk-norm at 64/8
# heads, and the deepest and widest dense stack.
DENSE_ARCHS = ("gemma2-2b", "gemma3-4b", "qwen3-32b", "deepseek-coder-33b")
# Short prompts beside the long one, new tokens per request, the flat
# policy's prefill chunk.
DENSE_SHORT, DENSE_NEW, DENSE_CHUNK = (24, 40, 64), 8, 512


def dense_requests(request_cls, cfg) -> list:
    """Phase 17b's traffic (numpy seed 0): one prompt longer than the
    config's attention window (window + 104 tokens; 512 without a window),
    so that its local layers mask at full width, and 3 short prompts; 8 new
    tokens each."""
    import numpy as np

    rng = np.random.default_rng(0)
    long = cfg.window_size + 104 if cfg.window_pattern else 512
    return [request_cls(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32),
                        max_new_tokens=DENSE_NEW)
            for i, n in enumerate((long,) + DENSE_SHORT)]


def dense_config_phase(torch, cfg) -> dict:
    """17b for one config: full-width params drawn and frozen one layer at
    a time, 4 slots, the traffic of :func:`dense_requests` under ``flat``
    (prefill chunk 512) and ``whole``: every
    request finishes, every logit finite, ``tsar_matmul`` launching what
    the plan predicts, greedy tokens
    equal (near-tie rule); the dry-run's peak for one decode step at 4 x
    ``max_len`` (packed, bf16 cache) within 5 % of the card's
    ``max_memory_allocated`` for the same step; ``tsar_matmul`` at the
    config's 7 projections x N = 4, timed, summed over the layers."""
    import numpy as np

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo
    from repro_torch.serving import Request, ServingEngine

    dev = torch.device("cuda")
    label = cfg.name
    params = init_frozen(torch, cfg, by_block=True, label=label)
    reqs = dense_requests(Request, cfg)
    max_len = -(-(max(len(r.prompt) for r in reqs) + DENSE_NEW + 2) // 16) * 16
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for policy in ("flat", "whole"):
        engine = ServingEngine(cfg, params, max_len=max_len, batch_slots=4,
                               prefill_chunk=DENSE_CHUNK, policy=policy, device=dev)
        engine.warmup(seq_len=64)
        runs[policy] = run_path(torch, engine, dense_requests(Request, cfg),
                                f"{label} {policy}")
        del engine
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    excuse = same_tokens_or_near_tie(torch, runs["flat"], runs["whole"],
                                     f"{label} flat vs whole")

    # The dry-run's decode step at 4 x max_len against the card's.
    shape = ShapeConfig("decode_card", max_len, 4, "decode")
    rec = dryrun.run_cell(cfg, shape, make_mesh((1, 1), ("data", "model")), "1x1",
                          weights="packed", verbose=False, fsdp=False,
                          cache_dtype=torch.bfloat16)
    _require(rec["status"] == "ok", f"dry-run {label} decode_card: {rec.get('error')}")
    mem = rec["memory_analysis"]
    pred = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    other = torch.cuda.memory_allocated() - FROZEN_ALLOC[label]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 1))).int().to(dev)
    cache = model_zoo.init_cache(cfg, 4, max_len, torch.bfloat16, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    logits, cache = model_zoo.decode_step(cfg, params, tokens, cache, max_len - 1)
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - other
    launches = launch_counts()["tsar_matmul"]
    _require(bool(torch.isfinite(logits).all()), f"{label} decode_card: logits")
    del logits, cache, tokens
    gap = abs(card - pred) / pred
    _require(launches == rec["kernels"].get("tsar_matmul", 0),
             f"{label} decode_card: {launches} launches, tally {rec['kernels']}")
    _require(gap <= 0.05, f"{label} decode_card: card peak {card} B against {pred:.0f} B "
             f"predicted ({100 * gap:.2f} %)")

    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = step_shapes(cfg)
    points = {(k, m): matmul_point(torch, gen, 4, k, m) for k, m in sorted(
        {(k, m) for _, k, m in shapes})}
    kern = {key: sum(points[(k, m)][key] for _, k, m in shapes) * cfg.n_layers
            for key in ("ms", "bound_ms")}
    f, w = runs["flat"], runs["whole"]
    print(f"{label} (17b): {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, prompts {[len(r.prompt) for r in reqs]}"
          f"{f' (window {cfg.window_size})' if cfg.window_pattern else ''}, max_len {max_len} | "
          f"flat: decode {f['decode_ms']:.2f} ms/step, prefill {f['prefill_ms']:.2f} ms/call "
          f"(chunk {DENSE_CHUNK}), {f['steps']} steps | whole: decode {w['decode_ms']:.2f} "
          f"ms/step, prefill {w['prefill_ms']:.2f} ms/call, {w['steps']} steps | tokens "
          f"{'equal' if excuse is None else 'equal but one near tie'} | serving peak "
          f"{serve_peak:.2f} GiB | decode step at 4 x {max_len}: dry-run {pred / 2**30:.3f} "
          f"GiB, card {card / 2**30:.3f} GiB ({100 * gap:.2f} % off), {launches} launches = "
          f"tally | tsar_matmul per N=4 step {kern['ms']:.4f} ms (bound {kern['bound_ms']:.4f} "
          f"ms) | {gpu_line()}", flush=True)
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"decode_ms": f["decode_ms"], "prefill_ms": f["prefill_ms"],
            "whole_decode_ms": w["decode_ms"], "whole_prefill_ms": w["prefill_ms"],
            "peak_gib": serve_peak, "card_peak": card, "pred_peak": pred,
            "kernel_ms": kern["ms"], "bound_ms": kern["bound_ms"], "near_tie": excuse}


def whole_phase(torch, cfg, per_step: int, per_prefill: int, by_block: bool = True,
                max_len: int = 256, traced: bool = False) -> dict:
    """Full-width serving under ``whole`` (the SSM, hybrid, enc-dec and VLM
    families), twice: equal greedy tokens, ``tsar_matmul`` launches
    per_step per decode step plus per_prefill per whole prefill, the
    wrapper's pad copies counted, the phase's peak device memory; then the
    reduced config against the CPU.  ``traced`` attaches an
    ``EventTracer`` to both runs, whose structure fingerprints must be
    equal."""
    from repro_torch.kernels import tsar_matmul as tm
    from repro_torch.obs import trace
    from repro_torch.serving import Request

    label = cfg.family
    params = init_frozen(torch, cfg, by_block=by_block, label=label)
    torch.cuda.reset_peak_memory_stats()
    pad = tm.pad_for_tma
    copies = {}          # row count of the call -> pad copies made

    def counting_pad(a_q, sign, zero, w_scale):
        out = pad(a_q, sign, zero, w_scale)
        if out[1] is not sign:
            copies[a_q.shape[0]] = copies.get(a_q.shape[0], 0) + 1
        return out

    runs = []
    tm.pad_for_tma = counting_pad
    try:
        for i in range(2):
            tracer = trace.EventTracer() if traced else None
            engine = dense_engine(torch, cfg, params, max_len=max_len,
                                  profile_density=i == 0, tracer=tracer)
            _require(engine.policy == "whole", f"{label}: policy {engine.policy}")
            copies.clear()
            run = run_path(torch, engine, make_requests(Request, cfg), f"{label} whole run {i + 1}")
            if traced:
                run["fingerprint"] = trace.structure_fingerprint(tracer.events)
                run["events"] = len(tracer.events)
            # Decode steps run 4 rows (4 slots x 1); prompts are 16-128 rows.
            run["pad_copies"] = sum(copies.values())
            run["pad_copies_per_step"] = copies.get(engine.slots, 0) / run["steps"]
            want = per_step * run["steps"] + per_prefill * run["whole_prefills"]
            _require(run["launches"]["tsar_matmul"] == want,
                     f"{label}: tsar_matmul launched {run['launches']['tsar_matmul']} times, "
                     f"expected {per_step} x {run['steps']} steps + {per_prefill} x "
                     f"{run['whole_prefills']} whole prefills = {want}")
            runs.append(run)
            del engine
    finally:
        tm.pad_for_tma = pad
    peak = torch.cuda.max_memory_allocated() / 2**30
    same_tokens(torch, runs[0], runs[1], f"{label} whole run 1 vs run 2")
    r = runs[0]
    if traced:
        _require(runs[0]["fingerprint"] == runs[1]["fingerprint"],
                 f"{label}: traced whole runs fingerprint {runs[0]['fingerprint']} and "
                 f"{runs[1]['fingerprint']}")
        print(f"{label}: both whole runs traced, one structure fingerprint "
              f"{r['fingerprint'][:23]}... ({r['events']} events)", flush=True)
    print(f"{label}: {cfg.name} tokens equal across two runs | launches {per_step}/decode "
          f"step + {per_prefill}/whole prefill | the wrapper's pad copies: "
          f"{r['pad_copies']} over {r['launches']['tsar_matmul']} launches, "
          f"{r['pad_copies_per_step']:g} per decode step | decode {r['decode_ms']:.2f} ms/step, "
          f"whole prefill {r['prefill_ms']:.2f} ms/call, TTFT p50 {r['ttft_ms']:.1f} ms, "
          f"TPOT p50 {r['tpot_ms']:.2f} ms | peak device memory {peak:.2f} GiB | "
          f"{gpu_line()}", flush=True)
    del params
    whole_agreement(torch, cfg)
    return {"runs": runs, "peak_gib": peak}


def large_kernel_phase(torch, cfgs: dict) -> dict:
    """``tsar_matmul`` at every (K, M) of the enc-dec and VLM models' kernel
    projections x ``LARGE_NS`` rows, ``torch.equal`` to the plain version,
    timed at N = 4, 20 and the model's large N (``cfgs``: config -> large
    N); at N = 1500 all-zero activation rows (the engine's stub frames and
    patches) through ``ops.tsar_matmul`` equal the plain version and give a
    zero, finite output."""
    from repro_torch.core import ternary
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    for cfg, large in cfgs.items():
        for k, m in sorted({(k, m) for _, k, m in step_shapes(cfg)}):
            for n in LARGE_NS:
                rows[(n, k, m)] = matmul_point(torch, gen, n, k, m, timed=n in (4, 20, large))
            x = torch.zeros((1500, k), device=dev)
            t = torch.randint(-1, 2, (k, m), generator=gen, device=dev).to(torch.float32)
            tw = ternary.pack(t, torch.rand((m,), generator=gen, device=dev) + 0.01)
            got, want = ops.tsar_matmul(x, tw), ref.quantized_matmul_ref(x, tw)
            _require(torch.equal(got, want) and not bool(got.abs().amax() > 0)
                     and bool(torch.isfinite(got).all()),
                     f"tsar_matmul on 1500 zero rows at K={k} M={m}")
            print(f"tsar_matmul K={k} M={m} ({cfg.name}): equal to the plain version at "
                  f"N in {LARGE_NS} and on 1500 all-zero rows", flush=True)
    for cfg, large in cfgs.items():
        shapes = step_shapes(cfg)
        for n in (4, 20, large):
            tot = {key: sum(rows[(n, k, m)][key] for _, k, m in shapes)
                   for key in ("ms", "bound_ms", "library_ms")}
            print(f"{cfg.name}: one layer's {len(shapes)} projections at N={n}: tsar_matmul "
                  f"{tot['ms']:.4f} ms (bound {tot['bound_ms']:.4f} ms, _int_mm "
                  f"{tot['library_ms']:.4f} ms)", flush=True)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows.values())}


def _flat_leaves(tree, path: str = "") -> dict:
    """path -> tensor of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_leaves(sub, f"{path}/{key}" if path else key).items()}
    return {path: tree}


def train_phase(torch, cfg) -> dict:
    """Full-width training, then serving the trained weights: ``init_state``
    on the card (generator seed 0), ``TRAIN_STEPS`` steps of
    ``make_train_step(remat=True, accum_steps=TRAIN_ACCUM)`` on the
    synthetic stream (sequence ``TRAIN_SEQ``, batch ``TRAIN_BATCH``): the
    loss and gradient norm finite, every leaf moved, no T-SAR kernel
    launched; then the optimizer state is dropped, the params frozen, and 4
    requests x 8 tokens served by ``ServingEngine(packed=True)``
    (``tsar_matmul`` launches as the plan predicts) and by
    ``ServingEngine(packed=False)`` on the trained latent params (no
    launch): equal greedy tokens."""
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.optim import OptConfig
    from repro_torch.serving import Request, freeze_params
    from repro_torch.train import init_state, make_train_step

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = OptConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = _flat_leaves(state.params)
    n_params = sum(v.numel() for v in leaves.values())
    start = {k: v.to("cpu", copy=True) for k, v in leaves.items()}
    print(f"train: {cfg.name} init_state {t_init:.2f} s, {n_params / 1e9:.3f} B latent "
          f"params in {len(leaves)} leaves, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "resident (params + two float32 moments)", flush=True)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    step = make_train_step(cfg, opt_cfg, remat=True, accum_steps=TRAIN_ACCUM)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    steps = []
    zero_launch_counts()
    for i in range(TRAIN_STEPS):
        batch = stream.batch(i, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"loss": loss, "grad_norm": gnorm, "s": dt})
        _require(math.isfinite(loss) and math.isfinite(gnorm),
                 f"train step {i}: loss {loss}, grad_norm {gnorm}")
        print(f"train step {i}: loss {loss:.4f}, grad_norm {gnorm:.4f}, lr "
              f"{float(m['lr']):.3g}, {dt:.3f} s, {tokens / dt:.0f} tokens/s, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    _require(launch_counts() == dict.fromkeys(COUNTERS, 0),
             f"training launched T-SAR kernels: {launch_counts()}")
    still = [k for k, v in leaves.items() if torch.equal(start[k].to(dev), v)]
    _require(not still, f"train: leaves that did not move: {still[:5]}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = state.params
    del state, m, start
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    frozen = freeze_params(params)
    torch.cuda.synchronize()
    t_freeze = time.perf_counter() - t0

    def reqs():
        out = make_requests(Request, cfg)[:4]
        for r in out:
            r.max_new_tokens = 8
        return out

    packed = run_path(torch, dense_engine(torch, cfg, frozen), reqs(), "trained packed")
    _require(packed["launches"]["tsar_matmul"] > 0, "the trained packed run launched nothing")
    latent = run_path(torch, dense_engine(torch, cfg, params, packed=False), reqs(),
                      "trained latent")
    same_tokens(torch, packed, latent, "trained weights: packed vs latent engine")
    gap = max((packed["rows"][key] - latent["rows"][key]).abs().max().item()
              for key in packed["rows"])
    times = [r["s"] for r in steps]
    losses = " -> ".join(f"{r['loss']:.4f}" for r in steps)
    print(f"train: {TRAIN_STEPS} steps of {tokens} tokens (remat, {TRAIN_ACCUM} microbatches): "
          f"loss {losses}, step {', '.join(f'{t:.3f}' for t in times)} s, "
          f"{tokens / statistics.median(times):.0f} "
          f"tokens/s at the median step, peak device memory {peak:.2f} GiB, every leaf moved "
          f"| freeze {t_freeze:.2f} s | packed and latent engines: equal greedy tokens, "
          f"largest logit gap {gap:.3g}, tsar_matmul launches {packed['launches']['tsar_matmul']}"
          f" / {latent['launches']['tsar_matmul']} | {gpu_line()}", flush=True)
    del frozen, params
    return {"steps": steps, "peak_gib": peak, "packed": packed, "latent": latent, "gap": gap}


def restart_phase(torch, cfg_full) -> None:
    """The reduced config on the card: 8 steps with a checkpoint every 2
    and a simulated failure at step 5 under ``run_with_restarts`` end with
    the state (params, moments, count) ``torch.equal`` to an uninterrupted
    8-step run; deterministic algorithms on for the phase."""
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import run_with_restarts
    from repro_torch.train import init_state, make_train_step

    cfg = cfg_full.reduced()
    dev = torch.device("cuda")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 64, 8, seed=5))
    step = make_train_step(cfg, opt_cfg)
    ckdir = str(ROOT / "build" / "chip_smoke_restart")
    shutil.rmtree(ckdir, ignore_errors=True)

    def fresh():
        return init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg, device=dev)

    crashes = {"armed": 1}

    def restore_fn():
        latest = ckpt.latest_step(ckdir)
        return (fresh(), 0) if latest is None else (ckpt.restore(ckdir, latest, fresh()), latest)

    def body(state, start):
        for i in range(start, 8):
            if i == 5 and crashes["armed"]:
                crashes["armed"] -= 1
                raise RuntimeError("simulated node failure")
            state, _ = step(state, stream.batch(i, device=dev))
            if (i + 1) % 2 == 0:
                ckpt.save(ckdir, i + 1, state)
        return 8

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        straight = fresh()
        for i in range(8):
            straight, _ = step(straight, stream.batch(i, device=dev))
        report = run_with_restarts(body, restore_fn=restore_fn, max_restarts=2)
        _require(report.completed and report.restarts == 1, f"restart: {report}")
        resumed = ckpt.restore(ckdir, 8, fresh())
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckdir, ignore_errors=True)
    want = {**_flat_leaves(straight.params), **_flat_leaves({"mu": straight.opt.mu}),
            **_flat_leaves({"nu": straight.opt.nu})}
    got = {**_flat_leaves(resumed.params), **_flat_leaves({"mu": resumed.opt.mu}),
           **_flat_leaves({"nu": resumed.opt.nu})}
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    _require(not differ and int(resumed.opt.count) == 8,
             f"restart: the resumed state differs from the uninterrupted run in {differ[:5]}")
    print(f"restart: reduced {cfg.name}, 8 steps, checkpoint every 2, failure at step 5: "
          f"{report.restarts} restart, resumed from step 4; params and moments "
          f"({len(want)} leaves) torch.equal to the uninterrupted run", flush=True)


def train_agreement(torch, cfgs: list, tol: float = 1e-4) -> None:
    """One train step of each family's reduced config on the card and on
    the CPU from the same params (drawn on the CPU, generator seed 0) and
    the same numpy-seeded batch: the losses within ``tol`` relative."""
    import numpy as np

    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import model_zoo
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import TrainState, make_train_step

    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    for cfg_full in cfgs:
        cfg = cfg_full.reduced()
        batch = SyntheticLMStream(DataConfig(cfg.vocab_size, 32, 2, seed=1)).batch_numpy(0)
        rng = np.random.default_rng(0)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model), dtype=np.float32)
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal((2, cfg.frontend_seq, cfg.frontend_dim),
                                                   dtype=np.float32)
        base = model_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out = []
        for dev in (torch.device("cuda"), torch.device("cpu")):
            params = _to(torch, base, dev)
            state = TrainState(params, adamw_init(params),
                               torch.zeros((), dtype=torch.int32, device=dev))
            tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v).to(dev)
                  for k, v in batch.items()}
            _, m = make_train_step(cfg, opt_cfg)(state, tb)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        (gpu_loss, gpu_norm), (cpu_loss, cpu_norm) = out
        rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
        print(f"reduced {cfg.name} train step GPU vs CPU: loss {gpu_loss:.7f} vs "
              f"{cpu_loss:.7f} (rel {rel:.3g}, tol {tol:.3g}), grad_norm {gpu_norm:.6f} vs "
              f"{cpu_norm:.6f}", flush=True)
        _require(math.isfinite(gpu_loss) and rel <= tol,
                 f"reduced {cfg.name} train step on the GPU disagrees with the CPU")


def _tree_nbytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in _flat_leaves(tree).values())


def dryrun_card_phase(torch, cfg, params) -> dict:
    """19a: the dry-run's bytes and kernel tally of two full-width cells
    beside what the card allocates and launches for the same tensors and
    step (``params``: the phase-8 tree, allocated by ``init_frozen``)."""
    import numpy as np

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_zoo

    dev = torch.device("cuda")
    mesh = make_mesh((1, 1), ("data", "model"))
    param_bytes = _tree_nbytes(params)
    out = {}
    for shape in (ShapeConfig(*c) for c in DRYRUN_CARD_CELLS):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(cfg, shape, mesh, "1x1", weights="packed", verbose=False,
                              fsdp=False, cache_dtype=torch.bfloat16)
        t_dry = time.perf_counter() - t0
        _require(rec["status"] == "ok", f"dry-run {shape.name}: {rec.get('error')}")
        mem = rec["memory_analysis"]
        pred_args, pred_temp = mem["argument_size_in_bytes"], mem["temp_size_in_bytes"]
        tally = rec["kernels"].get("tsar_matmul", 0)

        # The same inputs on the card: the batch (numpy seed 0) and the cache.
        gc.collect()
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        b, s = shape.global_batch, shape.seq_len
        rng = np.random.default_rng(0)
        rows = 1 if shape.kind == "decode" else s
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, rows),
                                               dtype=np.int32)).to(dev)
        cache = model_zoo.init_cache(cfg, b, s, torch.bfloat16, dev)
        extra = [torch.tensor(s - 1, dtype=torch.int32, device=dev)] \
            if shape.kind == "decode" else []
        torch.cuda.synchronize()
        inputs_alloc = torch.cuda.memory_allocated() - a0
        card_nbytes = (param_bytes + _tree_nbytes(cache) + tokens.numel() * 4
                       + sum(t.numel() * t.element_size() for t in extra))
        card_alloc = FROZEN_ALLOC["engine"] + inputs_alloc

        zero_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if shape.kind == "decode":
            logits, cache = model_zoo.decode_step(cfg, params, tokens, cache, s - 1)
        else:
            logits, cache = model_zoo.prefill(cfg, params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        launches = launch_counts()
        _require(bool(torch.isfinite(logits).all()), f"dry-run card {shape.name}: logits")
        del logits, cache, tokens, extra
        gc.collect()

        alloc_gap = abs(card_alloc - pred_args) / pred_args
        temp_gap = abs(peak - pred_temp) / pred_temp
        print(f"dry-run vs card, {cfg.name} {shape.name} ({shape.kind} {b} x {s}, packed, "
              f"bf16 cache; dry-run {t_dry:.2f} s on meta, step {t_step:.3f} s on the card): "
              f"arguments predicted {pred_args:.0f} B, card nbytes {card_nbytes} B, "
              f"allocated {card_alloc} B ({100 * alloc_gap:.3f} % off) | step temp "
              f"predicted {pred_temp:.0f} B ({pred_temp / 2**30:.3f} GiB), card peak beyond "
              f"the arguments {peak} B ({peak / 2**30:.3f} GiB, {100 * temp_gap:.2f} % off) | "
              f"tally tsar_matmul {tally}, launches {launches} | flops/dev "
              f"{rec['roofline']['flops_per_device']:.4g}, bound {rec['roofline']['bound']} "
              f"| {gpu_line()}", flush=True)
        _require(card_nbytes == pred_args,
                 f"{shape.name}: argument bytes {card_nbytes} on the card, {pred_args:.0f} "
                 "predicted")
        _require(alloc_gap <= 0.01, f"{shape.name}: allocated {card_alloc} B against "
                 f"{pred_args:.0f} B predicted ({100 * alloc_gap:.3f} %)")
        _require(launches["tsar_matmul"] == tally and launches["tsar_matmul"] > 0
                 and sum(launches.values()) == tally,
                 f"{shape.name}: tally {rec['kernels']}, launches {launches}")
        _require(temp_gap <= 0.25, f"{shape.name}: step peak {peak} B against {pred_temp:.0f} "
                 f"B predicted ({100 * temp_gap:.2f} %)")
        out[shape.name] = {"pred_args": pred_args, "card_nbytes": card_nbytes,
                           "card_alloc": card_alloc, "pred_temp": pred_temp, "peak": peak,
                           "tally": tally, "launches": launches["tsar_matmul"]}
    return out


def dryrun_train_prediction(torch, cfg, measured_gib: float) -> None:
    """19a, after phase 18: the dry-run's peak for the training cell beside
    the measured one (printed; the dry-run steps the whole batch at once,
    phase 18 in ``TRAIN_ACCUM`` microbatches)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    shape = ShapeConfig("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = dryrun.run_cell(cfg, shape, make_mesh((1, 1), ("data", "model")), "1x1",
                          weights="latent", verbose=False, fsdp=False, remat=True)
    _require(rec["status"] == "ok", f"dry-run train_card: {rec.get('error')}")
    mem = rec["memory_analysis"]
    pred = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2**30
    print(f"dry-run vs card, {cfg.name} training {TRAIN_BATCH} x {TRAIN_SEQ} (latent, remat): "
          f"predicted peak {pred:.2f} GiB (arguments "
          f"{mem['argument_size_in_bytes'] / 2**30:.2f} + step "
          f"{mem['temp_size_in_bytes'] / 2**30:.2f}; one batch of {TRAIN_BATCH}), phase 18 "
          f"measured {measured_gib:.2f} GiB ({TRAIN_ACCUM} microbatches) | {gpu_line()}",
          flush=True)


def sweep_phase(torch) -> list:
    """19b: every non-skipped cell, packed, per device on the single-pod
    16 x 16 mesh, and bitnet-2b-4t's cells on 16 x 16 and the multi-pod
    2 x 16 x 16 mesh: each traced at full width on meta as rank 0 of a fake
    world of 256 (512) ranks, one spawned process per CPU core."""
    import repro_torch.configs as configs
    from repro_torch.launch import dryrun, report

    jobs = [(c.name, s.name, "single", "packed", {}) for c, s, _ in configs.cells()]
    jobs += [("bitnet-2b-4t", s, m, "packed", {}) for m in ("single", "multi")
             for s in SWEEP_BITNET_SHAPES]
    # Longest first (train cells, then prefill, then decode), so that no
    # long cell starts last; the records are put back in the jobs' order.
    rank = {"train": 0, "prefill": 1, "decode": 2}
    order = sorted(range(len(jobs)), key=lambda i: rank[configs.SHAPES[jobs[i][1]].kind])
    workers = min(len(jobs), os.cpu_count() or 1)
    t0 = time.perf_counter()
    done = dict(zip(order, dryrun.sweep([jobs[i] for i in order], workers)))
    wall = time.perf_counter() - t0
    recs = [done[i] for i in range(len(jobs))]
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs
           if r["status"] != "ok"]
    _require(not bad, f"dry-run sweep: cells not ok: {bad}")
    for r in recs:
        f = r["roofline"]
        coll = {k: f"{v:.4g}" for k, v in sorted(f["collectives"].items())}
        print(f"dry-run {r['arch']} {r['shape']} {r['mesh']} ({r['chips']} devices, "
              f"{r['mode']}): per device flops {f['flops_per_device']:.4g}, temp "
              f"{r['memory_analysis']['temp_size_in_bytes']:.4g} B, bytes accessed "
              f"{r['cost']['bytes accessed']:.4g} B, all-to-all "
              f"{f['collectives'].get('all-to-all', 0.0):.4g} B, collective bytes "
              f"{coll}; compute {f['compute_s']:.4g} s, memory {f['memory_s']:.4g} s, "
              f"collective {f['collective_s']:.4g} s -> {f['bound']} ({r['wall_s']} s)"
              + "".join(f" | rank {k}: temp {v['memory_analysis']['temp_size_in_bytes']:.4g} "
                        f"B, bytes accessed {v['counts']['bytes accessed']:.4g} B, flops "
                        f"{v['counts']['flops']:.4g}" for k, v in r.get("ranks", {}).items()),
              flush=True)
        if r["mode"] == "train_step":
            _require(f["collectives"].get("all-gather", 0) > 0
                     and f["collectives"].get("reduce-scatter", 0) > 0,
                     f"dry-run {r['arch']} {r['shape']} {r['mesh']}: fsdp train cell without "
                     f"all-gather and reduce-scatter bytes: {f['collectives']}")
    sweep_outcomes(recs)
    n_bitnet = 2 * len(SWEEP_BITNET_SHAPES)
    print(f"dry-run sweep: {len(recs)}/{len(jobs)} cells ok per device ({len(jobs) - n_bitnet} "
          f"on 16 x 16, bitnet-2b-4t on 16 x 16 and 2 x 16 x 16, packed) in {wall:.1f} s "
          f"wall, {workers} processes, {sum(r['wall_s'] for r in recs):.1f} s of cells, torch "
          f"{torch.__version__}", flush=True)
    for mesh in ("single", "multi"):
        print(report.dryrun_table(recs, mesh))
        print(report.roofline_table(recs, mesh), flush=True)
    return recs


def sweep_outcomes(recs: list) -> None:
    """19b's gates on the mesh path's layout, per device (GB = 1e9 bytes;
    the limits are set from the layout before it: experts gathered whole
    on every rank and a sequence-split KV cache gathered in every layer):
    llama4-maverick-400b's train_4k holds at most 64.78 GB of temp (twice
    the ideal split) and all-gathers at least 10x less than 6,865.7 GB,
    with all-to-all bytes; deepseek-moe-16b's train_4k holds less than
    21.82 GB and all-gathers less than 146.2 GB; bitnet-2b-4t's decode_32k
    moves at most 8.09 GB of collectives on both meshes and holds less than
    6.04 GB (3.02 on 2 x 16 x 16); qwen3-32b's prefill_32k keeps its query
    heads split (8 KV heads on 16 'model' ranks) and accesses at most a
    tenth of the 868,199.7 GB the replicated heads did; a cell whose dims
    do not divide its axes carries rank 0's and the last rank's counts."""
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    for r in recs:
        ranks = sorted(r.get("ranks", {}), key=int)
        _require(ranks == (["0", str(r["chips"] - 1)] if r.get("uneven") else []),
                 f"dry-run {r['arch']} {r['shape']} {r['mesh']}: uneven {r.get('uneven')}, "
                 f"ranks {sorted(r.get('ranks', {}))}")
    qwen = by["qwen3-32b", "prefill_32k", "single"]["cost"]["bytes accessed"] / 1e9
    _require(qwen <= 868_199.7 / 10, f"dry-run qwen3-32b prefill_32k: {qwen:.1f} GB accessed")

    def get(arch, shape, mesh="single"):
        r = by[arch, shape, mesh]
        return (r["memory_analysis"]["temp_size_in_bytes"] / 1e9,
                {k: v / 1e9 for k, v in r["roofline"]["collectives"].items()})

    temp, coll = get("llama4-maverick-400b-a17b", "train_4k")
    _require(temp <= 64.78 and coll.get("all-gather", 0) * 10 <= 6865.7
             and coll.get("all-to-all", 0) > 0,
             f"dry-run llama4-maverick-400b train_4k: temp {temp:.2f} GB, collectives {coll}")
    temp, coll = get("deepseek-moe-16b", "train_4k")
    _require(temp < 21.82 and coll.get("all-gather", 0) < 146.2
             and coll.get("all-to-all", 0) > 0,
             f"dry-run deepseek-moe-16b train_4k: temp {temp:.2f} GB, collectives {coll}")
    for mesh, temp_was in (("single", 6.04), ("multi", 3.02)):
        temp, coll = get("bitnet-2b-4t", "decode_32k", mesh)
        _require(sum(coll.values()) <= 8.09 and temp < temp_was,
                 f"dry-run bitnet-2b-4t decode_32k {mesh}: temp {temp:.2f} GB, collectives "
                 f"{coll}")
    print("dry-run sweep outcomes: experts kept on 'model' (llama4-maverick-400b, "
          "deepseek-moe-16b train_4k) and split-KV decode (bitnet-2b-4t decode_32k, both "
          f"meshes) within their limits; qwen3-32b prefill_32k {qwen:.1f} GB accessed per "
          f"device; {sum('ranks' in r for r in recs)} cells traced as rank 0 and the last "
          "rank", flush=True)


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch) -> None:
    """19c: the three examples through ``main()`` with the default device
    (the card), each a path: launch counts zeroed before, read after."""
    runs = {}
    for name in ("torch_quickstart", "torch_serve_ternary", "torch_train_resume"):
        gc.collect()
        zero_launch_counts()
        t0 = time.perf_counter()
        result = _example(name).main([])
        runs[name] = (result, launch_counts(), time.perf_counter() - t0)
    out, launches, dt = runs["torch_quickstart"]
    losses = out["losses"]
    first, last = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    _require(last < first and launches["tsar_matmul"] > 0,
             f"quickstart: loss {first:.4f} -> {last:.4f}, launches {launches}")
    print(f"example torch_quickstart: {dt:.1f} s, loss {first:.4f} -> {last:.4f} (mean of the "
          f"first / last 10 of {len(losses)} steps), serving launches {launches}", flush=True)
    out, launches, dt = runs["torch_serve_ternary"]
    done = sum(r.done for r in out["requests"])
    load = out["engine"].max_step_tokens()
    _require(done == len(out["requests"]) and launches["tsar_matmul"] > 0
             and load <= out["budget"],
             f"serve_ternary: {done}/{len(out['requests'])} done, launches {launches}, "
             f"max step load {load} (budget {out['budget']})")
    print(f"example torch_serve_ternary: {dt:.1f} s, {done} requests done, launches "
          f"{launches}, max step load {load} <= budget {out['budget']}", flush=True)
    report, launches, dt = runs["torch_train_resume"]
    _require(report.completed and report.restarts == 1,
             f"train_resume: completed {report.completed}, restarts {report.restarts}")
    print(f"example torch_train_resume: {dt:.1f} s, completed after {report.restarts} "
          f"restart | {gpu_line()}", flush=True)


def mesh_dims(n: int) -> list:
    """The mesh phase's (data, model) meshes over ``n`` ranks."""
    return [(1, 1)] if n == 1 else [(n, 1), (1, n)]


def mesh_phase(torch) -> dict:
    """20. The serving cells, the sharded train step and the compressed
    data-parallel step across one NCCL rank per card (see the module
    docstring); the ranks run :func:`mesh_rank` in spawned processes and
    write their results under ``build/mesh_phase``."""
    import shutil
    import socket

    import torch.multiprocessing as mp

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    n = torch.cuda.device_count()
    print(f"mesh: world size {n}, one NCCL rank per card"
          + (": a world of one, so every collective below spans one rank (the "
             "exchange across ranks is held against the reference on gloo ranks on "
             "the CPU)" if n == 1 else ""), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "mesh_phase"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(n, port, str(out_dir)), nprocs=n,
                       start_method="spawn")
    wall = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(n)]
    per_step = len(step_shapes(configs_get(ARCH))) * configs_get(ARCH).n_layers
    for i, dims in enumerate(mesh_dims(n)):
        serve, train = ranks[0]["serve"][i], ranks[0]["train"][i]
        for r in ranks:
            rs, rt = r["serve"][i], r["train"][i]
            _require(rs["tokens_equal"], f"mesh {dims} rank {r['rank']}: tokens differ from "
                     "the unsharded cells")
            _require(rs["launches"] == [per_step], f"mesh {dims} rank {r['rank']}: "
                     f"tsar_matmul launches per step {rs['launches']}, want {per_step}")
            _require(abs(rt["loss"] - rt["plain_loss"]) <= 1e-4,
                     f"mesh {dims} rank {r['rank']}: sharded loss {rt['loss']} vs plain "
                     f"{rt['plain_loss']}")
            _require(rt["same_placements"], f"mesh {dims}: the state changed placements")
            # A world of one splits no cache on its sequence and no experts:
            # the split-KV and expert-parallel paths stay out of the way.
            _require(dims != (1, 1) or (rs["split_kv_calls"] == 0 and rt["all_to_all"] == 0),
                     f"mesh {dims}: split-KV calls {rs['split_kv_calls']}, token all-to-alls "
                     f"{rt['all_to_all']} on a world of one")
        rec = dryrun.run_cell(configs_get(ARCH), ShapeConfig("train_card", TRAIN_SEQ,
                                                             TRAIN_BATCH, "train"),
                              make_mesh(dims, ("data", "model")), f"{dims[0]}x{dims[1]}",
                              weights="latent", verbose=False, fsdp=True, remat=True)
        _require(rec["status"] == "ok", f"dry-run train_card {dims}: {rec.get('error')}")
        mem = rec["memory_analysis"]
        pred = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2**30
        print(f"mesh {dims[0]}x{dims[1]} serving, {MESH_SLOTS} slots x {MESH_PROMPT} prompt "
              f"tokens, {MESH_TOKENS} greedy tokens equal to the unsharded cells on every "
              f"rank, tsar_matmul launches per step {per_step} on every rank: prefill "
              f"{serve['prefill_ms']:.3f} ms (unsharded {serve['plain_prefill_ms']:.3f}), "
              f"decode {serve['decode_ms']:.3f} ms per step at the median (unsharded "
              f"{serve['plain_decode_ms']:.3f}); first mesh call {serve['first_ms']:.1f} ms "
              f"| {gpu_line()}", flush=True)
        print(f"mesh {dims[0]}x{dims[1]} jit_train_step(fsdp=True) {TRAIN_BATCH} x "
              f"{TRAIN_SEQ}, {train['accum']} microbatch(es), remat: loss {train['loss']:.6f} "
              f"(plain {train['plain_loss']:.6f}, |diff| "
              f"{abs(train['loss'] - train['plain_loss']):.2e}), step {train['step_s']:.3f} s "
              f"(plain loss_and_grads {train['plain_s']:.3f} s), peak device memory "
              f"{train['peak_gib']:.2f} GiB per device, dry-run predicted {pred:.2f} GiB "
              f"(arguments {mem['argument_size_in_bytes'] / 2**30:.2f} + step "
              f"{mem['temp_size_in_bytes'] / 2**30:.2f}) | {gpu_line()}", flush=True)
    comp = ranks[0]["compressed"]
    _require(all(math.isfinite(x) for x in comp["losses"]), f"compressed losses {comp}")
    print(f"mesh compressed data-parallel steps ({TRAIN_BATCH} x {TRAIN_SEQ} rows per rank, "
          f"world {n}, int8 all-to-all + bf16 all-gather over NCCL): loss "
          f"{' -> '.join(f'{x:.4f}' for x in comp['losses'])}, step "
          f"{', '.join(f'{x:.3f}' for x in comp['step_s'])} s, peak device memory "
          f"{comp['peak_gib']:.2f} GiB | phase wall {wall:.1f} s | {gpu_line()}", flush=True)
    return {"n": n, "ranks": ranks, "wall_s": wall}


def configs_get(name: str):
    import repro_torch.configs as configs

    return configs.get(name)


def mesh_rank(rank: int, n: int, port: int, out_dir: str) -> None:
    """One rank of the mesh phase (a spawned process): joins the NCCL group
    of the ``torchrun`` environment this sets, runs the serving cells, the
    sharded train step on each mesh and the compressed steps, and writes
    its results to ``out_dir/rank<r>.json``."""
    import datetime

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(n))
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import mesh as mesh_lib

    dev = mesh_lib.init_process_group("cuda", timeout=datetime.timedelta(seconds=300))
    try:
        cfg = configs_get(ARCH)
        res = {"rank": rank, "device": str(dev),
               "serve": [mesh_serve(torch, cfg, dims, dev) for dims in mesh_dims(n)],
               "train": [mesh_train(torch, cfg, dims, dev) for dims in mesh_dims(n)],
               "compressed": mesh_compressed(torch, cfg, n, dev)}
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _device_mesh(dims: tuple):
    from repro_torch.launch import mesh as mesh_lib

    return mesh_lib.device_mesh(mesh_lib.make_mesh(dims, ("data", "model")), "cuda")


def mesh_serve(torch, cfg, dims: tuple, dev) -> dict:
    """The frozen full-width model's prefill and greedy decode through the
    mesh cells and through the unsharded entry points, twice each (the
    second timed): tokens, launches per step, ms."""
    import numpy as np

    from repro_torch.kernels import tsar_matmul
    from repro_torch.launch import dryrun
    from repro_torch.models import layers, model_zoo
    from repro_torch.serving import freeze_params

    dm = _device_mesh(dims)
    params = freeze_params(model_zoo.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), sparse=False)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_SLOTS, MESH_PROMPT))).long().to(dev)
    max_len = MESH_PROMPT + MESH_TOKENS

    def greedy(prefill, decode, make_cache) -> dict:
        cache = make_cache()
        ms, launches = [], []
        out = []
        for i in range(MESH_TOKENS):
            tsar_matmul.LAUNCHES["tsar_matmul"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                logits, cache = prefill({"tokens": toks}, cache)
            else:
                logits, cache = decode(out[-1], cache, MESH_PROMPT + i - 1)
            nxt = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(tsar_matmul.LAUNCHES["tsar_matmul"])
            out.append(nxt)
        return {"tokens": torch.cat(out, 1).cpu(), "ms": ms, "launches": launches}

    split_calls = [0]
    attend_split = layers.attend_split

    def counted_split(*a, **kw):
        split_calls[0] += 1
        return attend_split(*a, **kw)

    layers.attend_split = counted_split
    try:
        with torch.no_grad():
            def plain_cache():
                return model_zoo.init_cache(cfg, MESH_SLOTS, max_len, torch.float32, dev)

            plain_run = [greedy(lambda b, c: model_zoo.prefill(cfg, params, b, c),
                                lambda tk, c, t: model_zoo.decode_step(cfg, params, tk, c, t),
                                plain_cache) for _ in range(2)]
            cells = dryrun.mesh_cells(cfg, params, dm)
            mesh_run = [greedy(cells.prefill, cells.decode_step,
                               lambda: cells.place_cache(plain_cache())) for _ in range(2)]
    finally:
        layers.attend_split = attend_split
    del cells, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"dims": dims,
            "tokens_equal": all(torch.equal(r["tokens"], plain_run[0]["tokens"])
                                for r in plain_run + mesh_run),
            "launches": sorted({x for r in mesh_run for x in r["launches"]}),
            "prefill_ms": mesh_run[1]["ms"][0], "plain_prefill_ms": plain_run[1]["ms"][0],
            "decode_ms": statistics.median(mesh_run[1]["ms"][1:]),
            "plain_decode_ms": statistics.median(plain_run[1]["ms"][1:]),
            "first_ms": mesh_run[0]["ms"][0], "split_kv_calls": split_calls[0]}


def mesh_train(torch, cfg, dims: tuple, dev) -> dict:
    """One ``jit_train_step(fsdp=True)`` step of the full-width model at
    phase 18's batch, beside the plain ``loss_and_grads`` on the same
    params and batch."""
    from repro_torch.checkpoint.checkpointing import _flatten
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import moe
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_state, jit_train_step, loss_and_grads

    dm = _device_mesh(dims)
    rows = TRAIN_BATCH // dims[0]
    accum = TRAIN_ACCUM if rows % TRAIN_ACCUM == 0 else 1
    opt_cfg = OptConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg, device=dev)
    batch = SyntheticLMStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH)).batch(
        0, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_loss, _, grads = loss_and_grads(cfg, state.params, batch, remat=True,
                                          accum_steps=accum)
    plain_loss = float(plain_loss)
    plain_s = time.perf_counter() - t0
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    step = jit_train_step(cfg, opt_cfg, dm, state, batch, fsdp=True, remat=True,
                          accum_steps=accum)
    placed = step.place(state)
    del state
    moe.EP_CALLS["all_to_all"] = 0
    torch.cuda.reset_peak_memory_stats()        # the step's peak
    before = [(k, tuple(map(str, v.placements))) for k, v in _flatten(placed).items()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, metrics = step(placed, batch)
    loss = float(metrics["loss"])
    step_s = time.perf_counter() - t0
    after = [(k, tuple(map(str, v.placements))) for k, v in _flatten(new).items()]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del placed, new, metrics, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"dims": dims, "accum": accum, "loss": loss, "plain_loss": plain_loss,
            "step_s": step_s, "plain_s": plain_s, "peak_gib": peak,
            "same_placements": before == after, "all_to_all": moe.EP_CALLS["all_to_all"]}


def mesh_compressed(torch, cfg, n: int, dev) -> dict:
    """Two ``make_compressed_dp_train_step`` steps over the world, each rank
    on ``TRAIN_BATCH`` rows of ``TRAIN_SEQ`` tokens."""
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_state, make_compressed_dp_train_step

    opt_cfg = OptConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg,
                       compressed=True, device=dev)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH * n))
    step = make_compressed_dp_train_step(cfg, opt_cfg, remat=True)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(2):
        batch = stream.batch(i, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": times, "peak_gib": peak}


def _to(torch, tree, dev):
    """A copy of a nested dict of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile 4 decode steps with torch.profiler")
    args = ap.parse_args()

    # cuBLAS reproducibility under torch.use_deterministic_algorithms (the
    # restart phase); read when the first cuBLAS handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    t_start = time.perf_counter()

    def elapsed(what: str) -> None:
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s after {what}", flush=True)

    # 3-7. kernels
    kern = kernel_phase(torch, cfg)
    sparse = sparse_kernel_phase(torch, cfg)
    lut_res = lut_kernel_phase(torch, cfg)
    compact = compact_kernel_phase(torch, cfg)
    flat_res = flat_attn_kernel_phase(torch, cfg)
    family_cfgs = [configs.get(a) for a in (MOE_ARCH, SSM_ARCH, HYBRID_ARCH)]
    family_kernel_phase(torch, family_cfgs)
    encdec_cfg, vlm_cfg = configs.get(ENCDEC_ARCH), configs.get(VLM_ARCH)
    large_kernel_phase(torch, {encdec_cfg: encdec_cfg.enc_seq, vlm_cfg: LARGE_NS[-1]})
    elapsed("phases 3-7 (kernels)")
    # 8-15. paths, each run with the launch counts zeroed just before it
    params = init_frozen(torch, cfg, kill_blocks=False)
    flat_run = engine_phase(torch, cfg, params, profile=args.profile)
    launches = flat_run["launches"]["tsar_matmul"]
    flat_launches = flat_run["flat_attn_launches"]
    policy_phase(torch, cfg, params, flat_run)
    prefix_runs = prefix_phase(torch, cfg, params)
    # 10a-10c. observability: the tight prefix run recorded, the step
    # annotations under torch.profiler, a reduced traced run card vs CPU
    obs_phase(torch, cfg, params, prefix_runs["warm, tight pool"])
    annotation_phase(torch, cfg, params)
    # 19a. the dry-run against what the card allocates for the same tree
    del flat_run, prefix_runs
    dryrun_card_phase(torch, cfg, params)
    elapsed("phases 8-10c, 19a (bitnet paths)")
    # 8b. the seven workload presets replayed on the same params; the CLI
    workload_phase(torch, cfg, params)
    elapsed("phase 8b (workload presets, serve CLI)")
    # 8c. the main path at the model's whole 4096-token context
    long_context_phase(torch, cfg, params)
    elapsed("phase 8c (long context)")
    del params
    cpu_agreement(torch, cfg)
    obs_agreement(torch, cfg)
    sparse_launches = sparse_engine_phase(torch, cfg)["launches"]
    bl_launches = bitlinear_phase(torch, cfg)["launches"]
    # 12a. the conformance grid through apply_frozen on the card
    grid_phase(torch)
    elapsed("phases 11-12a (sparse engine, bitlinear, grid)")
    # 13-15. the MoE, SSM and hybrid families' serving paths at full width
    moe_cfg, ssm_cfg, hybrid_cfg = family_cfgs
    moe_phase(torch, moe_cfg)
    elapsed("phase 13 (MoE)")
    for fcfg in (ssm_cfg, hybrid_cfg):
        shapes = step_shapes(fcfg)
        whole_phase(torch, fcfg, per_step=len(shapes) * fcfg.n_layers,
                    per_prefill=(len(shapes) + 1) * fcfg.n_layers)
    # 16-17. the enc-dec and VLM families' serving paths at full width.  A
    # decoder layer runs its self-attention, the cross block's wq and wo and
    # the MLP in every call; a whole prefill adds the encoder's layers and
    # the cross wk and wv over the encoder rows.
    per_layer = len(step_shapes(encdec_cfg))                  # 4 attention + 2 MLP
    whole_phase(torch, encdec_cfg, per_step=(per_layer + 2) * encdec_cfg.n_layers,
                per_prefill=per_layer * encdec_cfg.n_enc_layers
                + (per_layer + 4) * encdec_cfg.n_layers, by_block=False, traced=True)
    per_layer = len(step_shapes(vlm_cfg))
    whole_phase(torch, vlm_cfg, per_step=per_layer * vlm_cfg.n_layers,
                per_prefill=per_layer * vlm_cfg.n_layers,
                max_len=vlm_cfg.frontend_seq + 128 + 64)
    elapsed("phases 14-17 (SSM, hybrid, enc-dec, VLM)")
    # 17b. the four dense configs at full width, one at a time
    for arch in DENSE_ARCHS:
        dense_config_phase(torch, configs.get(arch))
    elapsed("phase 17b (dense configs)")
    # 18. training: full-width bitnet trained, frozen and served both ways;
    # a restart on the reduced config; one train step per family vs the CPU
    trained = train_phase(torch, cfg)
    dryrun_train_prediction(torch, cfg, trained["peak_gib"])
    del trained
    restart_phase(torch, cfg)
    train_agreement(torch, [cfg, moe_cfg, ssm_cfg, hybrid_cfg, encdec_cfg, vlm_cfg])
    elapsed("phase 18 (training)")
    # 19b-19c. the dry-run sweep on meta; the examples on the card
    sweep_phase(torch)
    elapsed("phase 19b (sweep)")
    examples_phase(torch)
    # 20. across devices: one NCCL rank per card
    mesh_phase(torch)
    elapsed("phase 20 (mesh)")

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
    # The flat attention kernel at one T=48 decode step of the cell's shapes
    # (a launch a layer), and per layer at both of its shapes.
    fl = flat_res["rows"]
    entries.append({
        "name": "flat_attn_f64", "route": "cuda", "source": "src/repro_torch/csrc/flat_attn.cu",
        "replaces": "none", "launches": flat_launches, "max_abs_err": flat_res["max_abs_err"],
        **{key: fl[48][key] * cfg.n_layers for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": fl[48]["bound_by"], "library_ms": None,
        "per_layer": {f"T={t}": {key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                                           "bound_by", "plain_device_ops")}
                      for t, row in fl.items()},
        "per": (f"one T=48 decode step of the bitnet-chat-b48 cell's shapes: {cfg.n_layers} "
                "launches over a (48, 2048) view; launches over the dense engine's run")})
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
