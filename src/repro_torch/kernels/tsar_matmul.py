"""Packed-ternary matmul: the hand-written Hopper kernel and its plain version.

Replaces ``src/repro/kernels/tsar_matmul.py::tsar_matmul_packed`` (the
``pallas_call`` at :124, body ``_kernel`` at :41).  The CUDA source is
``repro_torch/csrc/tsar_matmul.cu``; it is built with ``nvcc`` for
``sm_90a`` on first use and bound through ``ctypes``.

What bounds it: the serving step calls it at N = 4 (pure decode) or 20
(steps carrying prefill) rows, so it is bound by the 2-bit plane bytes,
K*M/4.  One call is one thread-block-cluster launch: the K splits of a
column tile are the CTAs of one cluster and sum their int32 partials through
distributed shared memory, so there is no workspace, memset or epilogue
kernel.  Each CTA copies its planes and activations into shared memory with
TMA, all stages requested at once, and
decodes the planes in registers into the A operand of int8 ``mma.sync``; no
int8 weight matrix ever reaches device memory.  See the source for the
layout; :func:`launch_config` picks the tiles.

On a CPU tensor :func:`tsar_matmul_packed` computes the plain version; on a
CUDA tensor it launches the kernel or raises; on a meta tensor it returns
the kernel's empty output and records the call in ``kernels.tally``.
``LAUNCHES`` counts the launches (and only those), so a run can show the
serving path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import ternary
from repro_torch.kernels import tally

# Launch counter; chip_smoke.py zeroes it before driving the serving path.
LAUNCHES = {"tsar_matmul": 0}

# Weights per plane byte, the reference's name for it here.
PACK = ternary.PACK

# Constants of the CUDA source (csrc/tsar_matmul.cu).
_COLS_PER_CTA = 64       # kBM
_K_STEP = 32             # kKStep: k per mma, the split granule
_ALIGN = 16              # bytes: TMA boxes start on 16-byte aligned rows
_WARPS = 8               # kWarps
_INBOX_BYTES = (2048 + 1024) * 4   # kInbox
_MAX_STAGE_STEPS = 64    # a plane TMA box has at most 256 rows
# Launch picks.
_SMEM_BUDGET = 228 * 1024 // 2 - 1024   # half an SM, less the runtime's 1 KiB per CTA
_MAX_CLUSTER = 8         # portable cluster size
_STAGES = 4              # ring stages, all issued before the first is consumed
_MIN_STAGE_STEPS = 8     # fewer stages for short k-ranges


def tsar_matmul_plain(a_q: torch.Tensor, a_scale: torch.Tensor,
                      sign_plane: torch.Tensor, zero_plane: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device.

    The int8 x ternary products are summed in float64, which is exact (every
    partial sum is an integer far below 2**53), then cast to float32 (exact:
    |sum| <= 127*K < 2**24) and scaled in the kernel's order.
    """
    t = ternary.decode_planes(sign_plane, zero_plane, a_q.shape[-1])
    acc = a_q.to(torch.float64) @ t.to(torch.float64)
    return acc.to(torch.float32) * a_scale * w_scale


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# C signature of tsar_matmul_packed: 6 pointers (a_q, a_scale, sign, zero,
# w_scale, out), 7 ints (n, kp, m, splits, n_tiles, stages, stage_steps),
# the stream.
_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *([ctypes.c_void_p] * 6),
                          *([ctypes.c_int] * 7), ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import _build

    return _PROTO(("tsar_matmul_packed", _build.load("tsar_matmul")))


class LaunchConfig(NamedTuple):
    """The CUDA kernel's picks for one call (see :func:`launch_config`)."""

    bm: int            # output columns per CTA
    splits: int        # K splits = CTAs of one cluster (1..8)
    n_tiles: int       # 8-row mma n-tiles per CTA (1..4; N > 32 adds grid rows)
    stages: int        # shared-memory ring stages
    stage_steps: int   # 32-k steps per stage


def smem_bytes(n_tiles: int, stages: int, stage_steps: int) -> int:
    """Dynamic shared memory of one CTA (``layout`` in the CUDA source):
    1024 bytes of mbarriers and scales, the 12 KiB inbox of the cluster
    reduction, then ``stages`` ring stages (activation boxes of 8*n_tiles
    rows x 128 k bytes, then two planes of stage_steps*4 byte rows x 64
    columns, rounded up to 1024 bytes) or, once they are consumed, the 8
    warps' int32 partial tiles (rows of 65 words), whichever is larger, and
    1024 bytes of alignment slack."""
    npad = 8 * n_tiles
    boxes = -(-stage_steps * _K_STEP // 128)
    stage = -(-(boxes * npad * 128 + 2 * stage_steps * (_K_STEP // 8) * _COLS_PER_CTA)
              // 1024) * 1024
    return (1024 + _INBOX_BYTES + max(stages * stage, _WARPS * npad * (_COLS_PER_CTA + 1) * 4)
            + 1024)


@functools.lru_cache(maxsize=1024)
def launch_config(n: int, kp: int, m: int, sm_count: int) -> LaunchConfig:
    """Tiles for an (n, kp) x (kp, m) problem.

    One wave of at most one CTA per SM: the column tiles (x row tiles of 32
    for n > 32) times the cluster size stay within ``sm_count``, with as
    many K splits (at most 8, each at least one 32-k step) as that allows.
    Each CTA's k-range is cut into at most 4 ring stages of at least 8 steps,
    all requested at once, within half an SM's shared memory (so that the
    scheduler can always place a cluster on whichever SMs are free); when
    they do not fit, the stages shrink and the ring turns over.  Padding
    ``kp`` or ``m`` to a multiple of 16 does not change the picks.
    """
    n_tiles = -(-min(n, 32) // 8)
    steps = -(-kp // _K_STEP)
    tiles = -(-m // _COLS_PER_CTA) * -(-n // 32)
    splits = max(1, min(_MAX_CLUSTER, steps, sm_count // tiles))
    per = -(-steps // splits)
    splits = -(-steps // per)                 # no empty split
    stages = min(_STAGES, -(-per // _MIN_STAGE_STEPS))
    stage_steps = min(_MAX_STAGE_STEPS, -(-per // stages))
    while stage_steps > 1 and smem_bytes(n_tiles, stages, stage_steps) > _SMEM_BUDGET:
        stage_steps -= 1
    stages = min(stages, -(-per // stage_steps))
    return LaunchConfig(_COLS_PER_CTA, splits, n_tiles, stages, stage_steps)


def _check(a_q, a_scale, sign_plane, zero_plane, w_scale) -> None:
    dev = a_q.device
    for name, t, dtype in (("a_q", a_q, torch.int8), ("a_scale", a_scale, torch.float32),
                           ("sign_plane", sign_plane, torch.uint8),
                           ("zero_plane", zero_plane, torch.uint8),
                           ("w_scale", w_scale, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a_q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_q.ndim != 2:
        raise ValueError(f"a_q must be (N, K), got {tuple(a_q.shape)}")
    n, kp = a_q.shape
    if sign_plane.ndim != 2 or sign_plane.shape != zero_plane.shape:
        raise ValueError(f"planes must be equal (K/8, M), got "
                         f"{tuple(sign_plane.shape)} and {tuple(zero_plane.shape)}")
    k8, m = sign_plane.shape
    if kp != 8 * k8:
        raise ValueError(f"a_q has {kp} columns, planes cover {8 * k8}")
    if tuple(a_scale.shape) != (n, 1):
        raise ValueError(f"a_scale must be ({n}, 1), got {tuple(a_scale.shape)}")
    if tuple(w_scale.shape) != (m,):
        raise ValueError(f"w_scale must be ({m},), got {tuple(w_scale.shape)}")


def pad_for_tma(a_q: torch.Tensor, sign_plane: torch.Tensor, zero_plane: torch.Tensor,
                w_scale: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Kp and M padded to multiples of 16, the row alignment of the
    kernel's TMA copies: zero activations meet the padded plane rows (which
    decode to +1) and the padded columns are cut off the output, so the
    product's first M columns are unchanged.  Returns the inputs themselves
    when no padding is needed."""
    dk, dm = -a_q.shape[1] % _ALIGN, -sign_plane.shape[1] % _ALIGN
    if dk or dm:
        a_q = F.pad(a_q, (0, dk))
        sign_plane = F.pad(sign_plane, (0, dm, 0, dk // 8))
        zero_plane = F.pad(zero_plane, (0, dm, 0, dk // 8))
        w_scale = F.pad(w_scale, (0, dm))
    return a_q, sign_plane, zero_plane, w_scale


def tsar_matmul_packed(a_q: torch.Tensor, a_scale: torch.Tensor,
                       sign_plane: torch.Tensor, zero_plane: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """(N, Kp) int8 x packed ternary (Kp/8, M) planes -> (N, M) float32.

    ``a_scale`` is (N, 1) float32, ``w_scale`` (M,) float32.  On CUDA the
    kernel's TMA copies need ``a_q`` and the planes 16-byte aligned (a
    ``ValueError`` otherwise) and Kp and M multiples of 16: other shapes are
    padded here (:func:`pad_for_tma`), which copies the planes, ``w_scale``
    and ``a_q`` on every call and the output's first M columns after it.
    Of the served configs' projections only ``hymba-1.5b``'s SSM
    ``in_proj`` (K 1600, M 6482, padded to 6496) copies; every other
    projection of every config has Kp and M multiples of 16.
    """
    _check(a_q, a_scale, sign_plane, zero_plane, w_scale)
    if a_q.device.type == "cpu":
        return tsar_matmul_plain(a_q, a_scale, sign_plane, zero_plane, w_scale)
    if a_q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {a_q.device}")
    meta = a_q.device.type == "meta"
    n, m = a_q.shape[0], sign_plane.shape[1]
    for name, t in (("a_q", a_q), ("sign_plane", sign_plane), ("zero_plane", zero_plane)):
        if not meta and t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be {_ALIGN}-byte aligned for the CUDA kernel")
    a_q, sign_plane, zero_plane, w_scale = pad_for_tma(a_q, sign_plane, zero_plane, w_scale)
    kp, mp = a_q.shape[1], sign_plane.shape[1]
    out = torch.empty((n, mp), dtype=torch.float32, device=a_q.device)
    if n == 0:
        return out[:, :m]
    if meta:
        tally.record("tsar_matmul", n, kp, mp,
                     (a_q, a_scale, sign_plane, zero_plane, w_scale, out))
        return out if mp == m else out[:, :m].contiguous()
    index = a_q.device.index if a_q.device.index is not None else torch.cuda.current_device()
    cfg = launch_config(n, kp, mp, _sm_count(index))
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(a_q.data_ptr(), a_scale.data_ptr(), sign_plane.data_ptr(),
                     zero_plane.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                     n, kp, mp, cfg.splits, cfg.n_tiles, cfg.stages, cfg.stage_steps,
                     stream)
    if err != 0:
        raise RuntimeError(f"tsar_matmul kernel launch failed: CUDA error {err}")
    LAUNCHES["tsar_matmul"] += 1
    return out if mp == m else out[:, :m].contiguous()
