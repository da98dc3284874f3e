"""Block-sparse packed-ternary matmul: the hand-written Hopper kernels and
their plain version.

Two entry points of ``repro_torch/csrc/tsar_sparse.cu`` (built with
``nvcc`` for ``sm_90a`` on first use and bound through ``ctypes``):

* :func:`tsar_sparse_padded_matmul_packed` replaces
  ``src/repro/kernels/tsar_sparse.py::tsar_sparse_padded_matmul_packed``
  (the ``pallas_call`` at :223, body ``_kernel_2d`` at :135): the padded
  pool of the serving step, with the activation skip;
* :func:`tsar_sparse_matmul_packed` replaces
  ``src/repro/kernels/tsar_sparse.py::tsar_sparse_matmul_packed`` (the
  ``pallas_call`` at :122, body ``_kernel`` at :46): the compacted pool of
  ``core.bitlinear`` (``max(n_live, 1)`` slots, a ``max(s_max, 1)`` walk),
  without the activation skip, as the TPU kernel has none.

What bounds them: at N = 4 or 20 rows the call is bound by the plane bytes
of the live blocks, ``sum_j counts[j] * 2 * (bk/8) * bm``, plus the
activations, the output, the scales and the schedule.  One call is one
thread-block-cluster launch: each m-strip's walk over its ``counts[j]``
live blocks is split over the CTAs of one cluster on the device (the host
reads shapes only), the live blocks' plane tiles and activation slices are
copied into shared memory with TMA, all stages requested at once, and the
planes are decoded in registers into the A operand of int8 ``mma.sync``;
the partial sums meet through distributed shared memory, so there is no
workspace, memset or epilogue kernel.  The skips drop exact int32 zeros, so
both outputs are bit-identical to ``tsar_matmul`` on the decoded matrix and
to the one plain version.  :func:`launch_config` picks the tiles.

On a CPU tensor each wrapper computes the plain version; on a CUDA tensor
it launches its kernel or raises; on a meta tensor it returns the kernel's
empty output and records the call in ``kernels.tally``.  ``LAUNCHES``
counts each entry point's launches apart, and only those.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import ternary
from repro_torch.kernels import tally
from repro_torch.kernels import tsar_matmul as _mxu_kernel

# Launch counters; chip_smoke.py zeroes them before driving a path.
LAUNCHES = {"tsar_sparse_padded": 0, "tsar_sparse": 0}

# Constants of the CUDA source (csrc/tsar_sparse.cu).
_COLS_PER_CTA = 64       # kBM
_CHUNK_ROWS = 32         # kChunkRows: plane rows (256 k) of one staged chunk at most
_ACT_BOX = 128           # kActBox: k bytes of one activation TMA box
_ALIGN = 16              # bytes: TMA boxes start on 16-byte aligned rows
_WARPS = 8               # kWarps
# Launch picks.
_SMEM_BUDGET = _mxu_kernel._SMEM_BUDGET   # half an SM, as tsar_matmul's
_MAX_CLUSTER = 8         # portable cluster size


def tsar_sparse_padded_plain(a_q: torch.Tensor, a_scale: torch.Tensor,
                             sign_pool: torch.Tensor, zero_pool: torch.Tensor,
                             kids: torch.Tensor, slots: torch.Tensor,
                             counts: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Both kernels' function in plain PyTorch, on any device.

    Decodes the pool slot of every walk step, zeroes the steps past
    ``counts[j]``, and sums ``a_q``'s k-block times the decoded block in
    float64 (exact: every partial sum is an integer far below 2**53), then
    casts to float32 (exact: |sum| <= 127*K < 2**24) and scales in the
    kernel's order.
    """
    n, kp = a_q.shape
    _, k8, bm = sign_pool.shape
    bk = 8 * k8
    mb, s_steps = kids.shape
    live = torch.arange(s_steps, device=a_q.device)[None, :] < counts[:, None]
    t = ternary.decode_planes(sign_pool[slots.long()].permute(2, 0, 1, 3),
                              zero_pool[slots.long()].permute(2, 0, 1, 3), bk)
    t = t.permute(1, 2, 0, 3).to(torch.float64) * live[:, :, None, None]  # (mb, S, bk, bm)
    a = a_q.to(torch.float64).reshape(n, kp // bk, bk)[:, kids.long()]    # (N, mb, S, bk)
    acc = torch.einsum("njsk,jskc->njc", a, t).reshape(n, mb * bm)
    return acc.to(torch.float32) * a_scale * w_scale


# The compacted kernel computes the same function: the walk over counts[j]
# live steps is the same, and the padded kernel's activation skip only drops
# exact int32 zeros.
tsar_sparse_compact_plain = tsar_sparse_padded_plain


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# C signature of both entry points: 9 pointers (a_q, a_scale, sign_pool,
# zero_pool, kids, slots, counts, w_scale, out), 11 ints (n, kp, bk, bm, mb,
# s_steps, pool_slots, cluster, n_tiles, stages, stage_chunks), the stream.
_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *([ctypes.c_void_p] * 9),
                          *([ctypes.c_int] * 11), ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    from repro_torch.kernels import _build

    return _PROTO((symbol, _build.load("tsar_sparse")))


class LaunchConfig(NamedTuple):
    """The CUDA kernel's picks for one call (see :func:`launch_config`)."""

    bm: int            # output columns per CTA
    cluster: int       # CTAs sharing one strip's live walk = cluster size (1..8)
    n_tiles: int       # 8-row mma n-tiles per CTA (1..4; N > 32 adds grid rows)
    stages: int        # shared-memory ring stages
    stage_blocks: int  # chunks per stage, each <= 256 k of one live block


def _head_bytes(n_tiles: int) -> int:
    """Shared memory before the ring (``layout`` in the CUDA source): 1 KiB
    of mbarriers, scales and the walk window, then the cluster inbox of
    8*n_tiles*64 + 8 int32 words, rounded up to 1024 bytes."""
    return 1024 + -(-(8 * n_tiles * _COLS_PER_CTA + 8) * 4 // 1024) * 1024


def _chunk_bytes(n_tiles: int, bk: int) -> int:
    """Shared memory of one staged chunk: the activation boxes of 8*n_tiles
    rows x 128 k bytes that cover min(bk, 256) k, then two planes of
    min(bk/8, 32) rows x 64 columns (128-byte rounded each), rounded up to
    1024 bytes."""
    rows = min(bk // 8, _CHUNK_ROWS)
    boxes = -(-8 * rows // _ACT_BOX)
    plane = -(-rows * _COLS_PER_CTA // 128) * 128
    return -(-(boxes * 8 * n_tiles * _ACT_BOX + 2 * plane) // 1024) * 1024


def smem_bytes(n_tiles: int, bk: int, stages: int, stage_blocks: int) -> int:
    """Dynamic shared memory of one CTA: the head, then ``stages`` stages of
    ``stage_blocks`` chunks or, once they are consumed, the 8 warps' int32
    partial tiles (8*n_tiles rows of 65 words), whichever is larger, and
    1024 bytes of alignment slack."""
    ring = stages * stage_blocks * _chunk_bytes(n_tiles, bk)
    red = _WARPS * 8 * n_tiles * (_COLS_PER_CTA + 1) * 4
    return _head_bytes(n_tiles) + max(ring, red) + 1024


@functools.lru_cache(maxsize=1024)
def launch_config(n: int, bk: int, bm: int, mb: int, s_steps: int,
                  sm_count: int) -> LaunchConfig:
    """Tiles for an (n, mb*bm) product over a pool of (bk, bm) blocks whose
    strips walk at most ``s_steps`` live blocks.  Shapes only: the live
    counts are data, read by the kernel.

    A CTA covers 64 columns of a strip.  The column tiles (x row tiles of
    32 for n > 32) times the cluster size make one wave of one CTA per SM,
    or of two (each within half an SM's shared memory) for n <= 8 or where
    one per SM would leave each strip's walk to a single CTA; each strip
    gets as many CTAs (at most 8 and at most ``s_steps``) as that allows.
    The ring holds the chunks of a CTA's share of the longest walk in one
    stage where they fit in half an SM's shared memory (as
    ``tsar_matmul``'s): all are requested at once and consumed after one
    wait.  Else two stages take turns.  Padding ``bm`` to 16 does not change
    the picks.
    """
    n_tiles = -(-min(n, 32) // 8)
    tiles = mb * -(-bm // _COLS_PER_CTA) * -(-n // 32)
    per_sm = 2 if n_tiles == 1 or 2 * tiles > sm_count else 1
    cluster = max(1, min(_MAX_CLUSTER, s_steps, per_sm * sm_count // tiles))
    walk = -(-s_steps // cluster) * -(-bk // (8 * _CHUNK_ROWS))   # chunks of the longest share
    fit = (_SMEM_BUDGET - _head_bytes(n_tiles) - 1024) // _chunk_bytes(n_tiles, bk)
    if walk <= fit:
        return LaunchConfig(_COLS_PER_CTA, cluster, n_tiles, 1, walk)
    return LaunchConfig(_COLS_PER_CTA, cluster, n_tiles, 2, fit // 2)


def _check(a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale) -> None:
    dev = a_q.device
    for name, t, dtype in (("a_q", a_q, torch.int8), ("a_scale", a_scale, torch.float32),
                           ("sign_pool", sign_pool, torch.uint8),
                           ("zero_pool", zero_pool, torch.uint8),
                           ("kids", kids, torch.int32), ("slots", slots, torch.int32),
                           ("counts", counts, torch.int32),
                           ("w_scale", w_scale, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a_q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_q.ndim != 2:
        raise ValueError(f"a_q must be (N, Kp), got {tuple(a_q.shape)}")
    n, kp = a_q.shape
    if sign_pool.ndim != 3 or sign_pool.shape != zero_pool.shape:
        raise ValueError(f"pools must be equal (max_live, bk/8, bm), got "
                         f"{tuple(sign_pool.shape)} and {tuple(zero_pool.shape)}")
    _, k8, bm = sign_pool.shape
    bk = 8 * k8
    if kids.ndim != 2 or kids.shape != slots.shape:
        raise ValueError(f"kids and slots must be equal (mb, s_steps), got "
                         f"{tuple(kids.shape)} and {tuple(slots.shape)}")
    mb, _ = kids.shape
    if tuple(counts.shape) != (mb,):
        raise ValueError(f"counts must be ({mb},), got {tuple(counts.shape)}")
    if bk == 0 or kp % bk:
        raise ValueError(f"a_q has {kp} columns, not a multiple of bk={bk}")
    if tuple(a_scale.shape) != (n, 1):
        raise ValueError(f"a_scale must be ({n}, 1), got {tuple(a_scale.shape)}")
    if tuple(w_scale.shape) != (mb * bm,):
        raise ValueError(f"w_scale must be ({mb * bm},), got {tuple(w_scale.shape)}")


def pad_for_tma(a_q: torch.Tensor, sign_pool: torch.Tensor, zero_pool: torch.Tensor,
                w_scale: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The operands with bk and bm padded to multiples of 16, so that every
    TMA box of the kernel starts on a 16-byte aligned row and column (and
    Kp = kb * bk is a multiple of 16).  A bk with bk % 16 == 8 grows by one
    plane row of zero weights (sign 0, zero 0xFF) per pool block and each
    k-block of ``a_q`` by 8 zero activations; each pool block's bm grows by
    columns of zero weights and each strip's ``w_scale`` by zeros, so the
    product over the padded operands, viewed as (N, mb, bm16), holds the
    product's (N, mb, bm) in its first bm columns.  Returns the inputs
    themselves when no padding is needed (the serving shapes)."""
    k8, bm = sign_pool.shape[1:]
    if k8 % 2:
        sign_pool = F.pad(sign_pool, (0, 0, 0, 1))
        zero_pool = F.pad(zero_pool, (0, 0, 0, 1), value=0xFF)
        a_q = F.pad(a_q.view(a_q.shape[0], -1, 8 * k8), (0, 8)).reshape(a_q.shape[0], -1)
    dm = -bm % _ALIGN
    if dm:
        sign_pool = F.pad(sign_pool, (0, dm))
        zero_pool = F.pad(zero_pool, (0, dm), value=0xFF)
        w_scale = F.pad(w_scale.view(-1, bm), (0, dm)).reshape(-1)
    return a_q, sign_pool, zero_pool, w_scale


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start 16-byte aligned."""
    return t if t.data_ptr() % _ALIGN == 0 else t.clone()


def _launch(symbol: str, counter: str, a_q, a_scale, sign_pool, zero_pool,
            kids, slots, counts, w_scale) -> torch.Tensor:
    """Check the inputs, then the plain version on the CPU, or one launch of
    the CUDA entry point ``symbol`` counted under ``LAUNCHES[counter]``."""
    _check(a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale)
    if a_q.device.type == "cpu":
        return tsar_sparse_padded_plain(a_q, a_scale, sign_pool, zero_pool,
                                        kids, slots, counts, w_scale)
    if a_q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {a_q.device}")
    n = a_q.shape[0]
    pool_slots, k8, bm = sign_pool.shape
    mb, s_steps = kids.shape
    if n == 0 or mb == 0:
        return torch.empty((n, mb * bm), dtype=torch.float32, device=a_q.device)
    meta = a_q.device.type == "meta"
    a_q, sign_pool, zero_pool, w_scale = pad_for_tma(
        *((a_q, sign_pool, zero_pool) if meta else
          (_aligned(a_q), _aligned(sign_pool), _aligned(zero_pool))), w_scale)
    kp, (k8, bmp) = a_q.shape[1], sign_pool.shape[1:]
    out = torch.empty((n, mb * bmp), dtype=torch.float32, device=a_q.device)
    if meta:
        tally.record(counter, n, kp, mb * bmp)
        return out if bmp == bm else out.view(n, mb, bmp)[:, :, :bm].reshape(n, mb * bm)
    index = a_q.device.index if a_q.device.index is not None else torch.cuda.current_device()
    cfg = launch_config(n, 8 * k8, bmp, mb, s_steps, _sm_count(index))
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(symbol)(a_q.data_ptr(), a_scale.data_ptr(), sign_pool.data_ptr(),
                             zero_pool.data_ptr(), kids.data_ptr(), slots.data_ptr(),
                             counts.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                             n, kp, 8 * k8, bmp, mb, s_steps, pool_slots, cfg.cluster,
                             cfg.n_tiles, cfg.stages, cfg.stage_blocks, stream)
    if err != 0:
        raise RuntimeError(f"{counter} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
    return out if bmp == bm else out.view(n, mb, bmp)[:, :, :bm].reshape(n, mb * bm)


def tsar_sparse_padded_matmul_packed(a_q: torch.Tensor, a_scale: torch.Tensor,
                                     sign_pool: torch.Tensor, zero_pool: torch.Tensor,
                                     kids: torch.Tensor, slots: torch.Tensor,
                                     counts: torch.Tensor,
                                     w_scale: torch.Tensor) -> torch.Tensor:
    """(N, Kp) int8 x padded block pool -> (N, mb*bm) float32.

    ``Kp = kb * bk`` (zero-padded), pools (max_live, bk/8, bm) uint8, the
    schedule ``kids``/``slots`` (mb, s_steps) and ``counts`` (mb,) int32,
    ``a_scale`` (N, 1) and ``w_scale`` (mb*bm,) float32.  On CUDA the
    kernel's TMA copies need bk and bm multiples of 16 and 16-byte aligned
    data: other inputs are padded or copied here (:func:`pad_for_tma`); the
    serving shapes copy nothing.
    """
    return _launch("tsar_sparse_padded_matmul_packed", "tsar_sparse_padded", a_q,
                   a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale)


def tsar_sparse_matmul_packed(a_q: torch.Tensor, a_scale: torch.Tensor,
                              sign_pool: torch.Tensor, zero_pool: torch.Tensor,
                              kids: torch.Tensor, slots: torch.Tensor,
                              counts: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """(N, Kp) int8 x compacted block pool -> (N, mb*bm) float32.

    The operands of :func:`tsar_sparse_padded_matmul_packed`, taken from a
    ``BlockSparseTernary``: pools (max(n_live, 1), bk/8, bm) and a
    ``kids``/``slots`` walk (mb, max(s_max, 1)).
    """
    return _launch("tsar_sparse_matmul_packed", "tsar_sparse", a_q, a_scale,
                   sign_pool, zero_pool, kids, slots, counts, w_scale)
