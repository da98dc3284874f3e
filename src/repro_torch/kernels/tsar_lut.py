"""Shared-LUT ternary matmul: the hand-written Hopper kernel and its plain
version.

Replaces ``src/repro/kernels/tsar_lut.py::tsar_lut_gemv`` (the
``pallas_call`` at :96, body ``_kernel`` at :32).  The CUDA source is
``repro_torch/csrc/tsar_lut.cu``; it is built with ``nvcc`` for ``sm_90a``
on first use and bound through ``ctypes``.

What bounds it: at N = 1 and 4 the uint8 index arrays, ``2 * (K/c) * M``
bytes (twice the 2-bit planes at c = 4); at N = 20 the table lookups,
``2 * N * (K/c) * M``.  One call is one thread-block-cluster launch: the K
splits of a column tile are the CTAs of one cluster and sum their f32
partials through distributed shared memory in rank order, so there is no
workspace, memset or epilogue kernel, and two calls on the same inputs give
the same bits.  Each CTA copies its index tiles and activation rows into
shared memory with TMA, all stages requested at once; each warp builds the
paper's TLUT ``S[p] = sum_i bit_i(p) * a_i`` in registers (two 16-entry
tables per warp at c = 4) and gathers it with ``__shfl_sync``, one column
per lane.  Two CTAs share an SM.  See the source for the layout;
:func:`launch_config` picks the tiles.  The activations are float32 and are not quantized, so the contract
is floating-point (rtol 1e-4, atol 2e-3 against the dense product), not
bit-exact.

On a CPU tensor :func:`tsar_lut_gemv` computes the plain version; on a CUDA
tensor it launches the kernel or raises; on a meta tensor it returns the
kernel's empty output and records the call in ``kernels.tally``.
``LAUNCHES`` counts the launches, and only those.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import lut
from repro_torch.kernels import tally

# Launch counter; chip_smoke.py zeroes it before driving a path.
LAUNCHES = {"tsar_lut": 0}

# Constants of the CUDA source (csrc/tsar_lut.cu).
_COLS_PER_CTA = 128      # kBM: 4 columns per lane
_MAX_ROWS = 32           # kMaxRows: rows per CTA tile at most
_WARPS = 8               # kWarps
_MAX_STAGES = 8          # kMaxStages
_ALIGN = 16              # bytes: TMA rows start 16-byte aligned
# Compiled rows-per-warp instances (c = 4, the serving case, and other c).
_ROWS_PER_WARP = {4: (1, 2, 4, 8, 16)}
_ROWS_PER_WARP_OTHER = (4, 16)
# Launch picks.
_SMEM_BUDGET = 228 * 1024 // 2 - 1024   # half an SM (two CTAs), less the runtime's 1 KiB each
_MAX_CLUSTER = 8         # portable cluster size
_STAGES = 4              # ring stages aimed at, all issued before the first is consumed


class LaunchConfig(NamedTuple):
    """The CUDA kernel's picks for one call (see :func:`launch_config`)."""

    bm: int                # output columns per CTA
    rows: int              # rows per CTA tile (more rows add grid rows)
    rows_per_warp: int     # the compiled instance: rows a warp's registers hold
    row_groups: int        # warps split the rows in 1 or 2 groups, the k-steps within
    splits: int            # K splits = CTAs of one cluster (1..8)
    blocks_per_split: int  # c-blocks of one CTA's k-range
    stages: int            # shared-memory ring stages
    stage_blocks: int      # c-blocks per stage


def tsar_lut_plain(a: torch.Tensor, idx_pos: torch.Tensor, idx_zero: torch.Tensor,
                   w_scale: torch.Tensor, c: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the LUT
    identity through ``core.lut.tsar_lut_matmul`` (gathers materialised as
    (N, K/c, M) tensors)."""
    return lut.tsar_lut_matmul(a, idx_pos, idx_zero, c, w_scale)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# C signature of tsar_lut_gemv: 5 pointers (a, idx_pos, idx_zero, w_scale,
# out), 12 ints (n, blocks, mp, m, c, rows, rows_per_warp, row_groups,
# splits, blocks_per_split, stages, stage_blocks), the stream.
_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *([ctypes.c_void_p] * 5),
                          *([ctypes.c_int] * 12), ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import _build

    return _PROTO(("tsar_lut_gemv", _build.load("tsar_lut")))


def _granule(c: int) -> int:
    """c-blocks of one split or stage step: whole warp steps (32 / 2^c blocks
    for c <= 5) and 16-byte activation rows (4 blocks)."""
    return max(4, 32 >> c if c <= 5 else 1)


def smem_bytes(c: int, rows: int, row_groups: int, stages: int, stage_blocks: int) -> int:
    """Dynamic shared memory of one CTA (``layout`` in the CUDA source): the
    mbarriers and the cluster inbox (one f32 tile of rows x 128 and 32
    floats), then ``stages`` ring stages (two index
    tiles of stage_blocks x 128 bytes and an activation box of rows x
    stage_blocks*c floats, each rounded up to 128 bytes) or, once they are
    consumed, the warps' f32 partial tiles, whichever is larger, and 128
    bytes of alignment slack."""
    r128 = lambda x: -(-x // 128) * 128  # noqa: E731
    ring = r128(_MAX_STAGES * 8 + (rows * _COLS_PER_CTA + 32) * 4)
    stage = 2 * r128(stage_blocks * _COLS_PER_CTA) + r128(rows * stage_blocks * c * 4)
    red = _WARPS // row_groups * rows * _COLS_PER_CTA * 4
    return ring + max(stages * stage, red) + 128


def _ring(c: int, rows: int, row_groups: int, per: int) -> tuple[int, int]:
    """(stages, stage_blocks) for a k-range of ``per`` c-blocks: about 4
    stages, all requested at once, within half an SM's shared memory; where
    the whole k-range does not fit in 8 stages, 2 or more stages of the
    largest box turn over."""
    granule = _granule(c)
    max_sb = min(256, 256 // c) // granule * granule   # TMA boxes: <= 256 rows / elements
    want = min(max_sb, -(-per // _STAGES // granule) * granule)

    def fits(stages, sb):
        return smem_bytes(c, rows, row_groups, stages, sb) <= _SMEM_BUDGET

    for sb in range(want, 0, -granule):          # the whole k-range at once
        stages = -(-per // sb)
        if stages > _MAX_STAGES:
            break
        if fits(stages, sb):
            return stages, sb
    sb, stages = want, min(_MAX_STAGES, -(-per // want))   # a ring that turns over
    while not fits(stages, sb):
        if stages > 2:
            stages -= 1
        elif sb > granule:
            sb -= granule
        else:
            return 1, sb
    return stages, sb


@functools.lru_cache(maxsize=1024)
def launch_config(n: int, blocks: int, mp: int, c: int, sm_count: int) -> LaunchConfig:
    """Tiles for an (n, blocks*c) x (blocks, mp) problem.

    128-column tiles x row tiles (at most 32 rows) x K splits (the CTAs of
    one cluster, 1, 2, 4 or 8: clusters of other sizes pack the SMs worse),
    at most two CTAs per SM in one wave.  Of those, the pick least loads a
    CTA, counting its work as c-blocks x (rows + 1): the lookups and the
    per-step index work.  A CTA's time grows with its own work, whether or
    not it shares its SM, so more and smaller CTAs win up to the wave.  Up
    to 16 rows go to every warp, which then splits the k-steps 8 ways;
    above that the rows form two groups of 4 warps.
    """
    granule = _granule(c)
    col_tiles = -(-mp // _COLS_PER_CTA)
    units = -(-blocks // granule)
    picks = []
    for rows in sorted({-(-min(n, _MAX_ROWS) // j) for j in range(1, 9)}):
        tiles = col_tiles * -(-n // rows)
        for splits in (1, 2, 4, _MAX_CLUSTER):
            per_units = -(-units // splits)
            splits = -(-units // per_units)          # no empty split
            over = tiles * splits > 2 * sm_count     # past one wave: the fewest CTAs
            picks.append((over, 0 if over else per_units * (rows + 1), -rows, splits))
    _, _, rows, splits = min(picks)
    rows = -rows
    per = -(-units // splits) * granule
    row_groups = 1 if rows <= 16 else 2
    rw = next(r for r in _ROWS_PER_WARP.get(c, _ROWS_PER_WARP_OTHER)
              if -(-rows // row_groups) <= r)
    stages, sb = _ring(c, rows, row_groups, per)
    return LaunchConfig(_COLS_PER_CTA, rows, rw, row_groups, splits, per, stages, sb)


def _check(a, idx_pos, idx_zero, w_scale, c) -> None:
    dev = a.device
    for name, t, dtype in (("a", a, torch.float32), ("idx_pos", idx_pos, torch.uint8),
                           ("idx_zero", idx_zero, torch.uint8),
                           ("w_scale", w_scale, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= c <= 8:
        raise ValueError(f"block size c must be in 1..8, got {c}")
    if a.ndim != 2:
        raise ValueError(f"a must be (N, K), got {tuple(a.shape)}")
    if idx_pos.ndim != 2 or idx_pos.shape != idx_zero.shape:
        raise ValueError(f"indices must be equal (K/c, M), got "
                         f"{tuple(idx_pos.shape)} and {tuple(idx_zero.shape)}")
    blocks, m = idx_pos.shape
    if a.shape[1] != blocks * c:
        raise ValueError(f"a has {a.shape[1]} columns, indices cover {blocks * c}")
    if tuple(w_scale.shape) != (m,):
        raise ValueError(f"w_scale must be ({m},), got {tuple(w_scale.shape)}")


def pad_for_tma(a: torch.Tensor, idx_pos: torch.Tensor, idx_zero: torch.Tensor,
                w_scale: torch.Tensor, c: int) -> tuple[torch.Tensor, ...]:
    """Blocks padded so that ``blocks * c`` is a multiple of 4 and M to a
    multiple of 16, the 16-byte row alignment of the kernel's TMA copies:
    padded blocks carry zero activations (any index adds 0) and the padded
    columns are cut off the output, so the product's first M columns are
    unchanged.  Returns the inputs themselves when no padding is needed."""
    db = -idx_pos.shape[0] % (4 // math.gcd(c, 4))
    dm = -idx_pos.shape[1] % _ALIGN
    if db:
        a = F.pad(a, (0, db * c))
    if db or dm:
        idx_pos = F.pad(idx_pos, (0, dm, 0, db))
        idx_zero = F.pad(idx_zero, (0, dm, 0, db))
    if dm:
        w_scale = F.pad(w_scale, (0, dm))
    return a, idx_pos, idx_zero, w_scale


def tsar_lut_gemv(a: torch.Tensor, idx_pos: torch.Tensor, idx_zero: torch.Tensor,
                  w_scale: torch.Tensor, *, c: int = 4) -> torch.Tensor:
    """(N, K) float32 x encoded ternary (K/c, M) -> (N, M) float32.

    ``K = blocks * c`` (the caller zero-pads a ragged tail), indices uint8
    with every byte below ``2**c``, ``w_scale`` (M,) float32.  On CUDA the
    kernel's TMA copies need ``a`` and the indices 16-byte aligned (a
    ``ValueError`` otherwise), ``blocks * c`` a multiple of 4 and M of 16:
    other shapes are padded here (:func:`pad_for_tma`).  The serving shapes
    copy nothing.
    """
    _check(a, idx_pos, idx_zero, w_scale, c)
    if a.device.type == "cpu":
        return tsar_lut_plain(a, idx_pos, idx_zero, w_scale, c)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {a.device}")
    meta = a.device.type == "meta"
    for name, t in (("a", a), ("idx_pos", idx_pos), ("idx_zero", idx_zero)):
        if not meta and t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be {_ALIGN}-byte aligned for the CUDA kernel")
    n = a.shape[0]
    blocks, m = idx_pos.shape
    if n == 0 or m == 0 or blocks == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=a.device)
    a, idx_pos, idx_zero, w_scale = pad_for_tma(a, idx_pos, idx_zero, w_scale, c)
    blocks, mp = idx_pos.shape
    out = torch.empty((n, m), dtype=torch.float32, device=a.device)
    if meta:
        tally.record("tsar_lut", n, blocks * c, mp, (a, idx_pos, idx_zero, w_scale, out))
        return out
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    cfg = launch_config(n, blocks, mp, c, _sm_count(index))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(a.data_ptr(), idx_pos.data_ptr(), idx_zero.data_ptr(),
                     w_scale.data_ptr(), out.data_ptr(), n, blocks, mp, m, c, cfg.rows,
                     cfg.rows_per_warp, cfg.row_groups, cfg.splits, cfg.blocks_per_split,
                     cfg.stages, cfg.stage_blocks, stream)
    if err != 0:
        raise RuntimeError(f"tsar_lut kernel launch failed: CUDA error {err}")
    LAUNCHES["tsar_lut"] += 1
    return out
