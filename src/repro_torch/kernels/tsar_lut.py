"""Shared-LUT ternary matmul: the hand-written Hopper kernel and its plain
version.

Replaces ``src/repro/kernels/tsar_lut.py::tsar_lut_gemv`` (the
``pallas_call`` at :96, body ``_kernel`` at :32).  The CUDA source is
``repro_torch/csrc/tsar_lut.cu``; it is built with ``nvcc`` for ``sm_90a``
on first use and bound through ``ctypes``.

What bounds it: the uint8 index arrays, ``2 * (K/c) * M`` bytes (twice the
2-bit planes at c = 4), and at N = 20 the shared-memory lookups.  The kernel
builds each chunk's LUT ``S[p] = sum_i bit_i(p) * a_i`` in shared memory and
gathers it by index, the GPU form of the paper's in-register TLUT/TGEMV; see
the source for the launch layout.  The activations are float32 and are not
quantized, so the contract is floating-point (rtol 1e-4, atol 2e-3 against
the dense product), not bit-exact.

On a CPU tensor :func:`tsar_lut_gemv` computes the plain version; on a CUDA
tensor it launches the kernel or raises.  ``LAUNCHES`` counts the launches,
and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import lut
from repro_torch.kernels import tsar_matmul as _mxu_kernel

# Launch counter; chip_smoke.py zeroes it before driving a path.
LAUNCHES = {"tsar_lut": 0}

_TILE_COLS = 256         # kTileCols in the CUDA source
_LUT_FLOATS = 4096       # shared-memory LUT budget per CTA (16 KiB)
_MAX_CHUNK_BLOCKS = 64


def tsar_lut_plain(a: torch.Tensor, idx_pos: torch.Tensor, idx_zero: torch.Tensor,
                   w_scale: torch.Tensor, c: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the LUT
    identity through ``core.lut.tsar_lut_matmul`` (gathers materialised as
    (N, K/c, M) tensors)."""
    return lut.tsar_lut_matmul(a, idx_pos, idx_zero, c, w_scale)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# C signature of tsar_lut_gemv: 6 pointers (a, idx_pos, idx_zero, w_scale,
# out, workspace), 8 ints (n, blocks, m, c, bn, cb, blocks_per_split,
# splits), the stream.
_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *([ctypes.c_void_p] * 6),
                          *([ctypes.c_int] * 8), ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import _build

    return _PROTO(("tsar_lut_gemv", _build.load("tsar_lut")))


def launch_config(n: int, blocks: int, m: int, c: int,
                  sm_count: int) -> tuple[int, int, int, int]:
    """(rows per CTA, blocks per LUT chunk, blocks per split, splits): the
    row tile of ``tsar_matmul``, as many blocks per chunk as a 16 KiB LUT
    holds, and enough K splits for about two CTAs per SM."""
    bn = _mxu_kernel.row_tile(n)
    cb = max(1, min(_MAX_CHUNK_BLOCKS, _LUT_FLOATS // (bn << c)))
    tiles = -(-m // _TILE_COLS) * -(-n // bn)
    split = min(blocks, max(1, -(-2 * sm_count // tiles)))
    per = -(-blocks // split)
    return bn, cb, per, -(-blocks // per)


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


def tsar_lut_gemv(a: torch.Tensor, idx_pos: torch.Tensor, idx_zero: torch.Tensor,
                  w_scale: torch.Tensor, *, c: int = 4) -> torch.Tensor:
    """(N, K) float32 x encoded ternary (K/c, M) -> (N, M) float32.

    ``K = blocks * c`` (the caller zero-pads a ragged tail), indices uint8
    with every byte below ``2**c``, ``w_scale`` (M,) float32.  On CUDA the
    kernel needs ``M % 4 == 0`` and 4-byte-aligned indices (``ops`` pads M).
    """
    _check(a, idx_pos, idx_zero, w_scale, c)
    if a.device.type == "cpu":
        return tsar_lut_plain(a, idx_pos, idx_zero, w_scale, c)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    n = a.shape[0]
    blocks, m = idx_pos.shape
    if m % 4:
        raise ValueError(f"the CUDA kernel needs M % 4 == 0, got M={m}")
    for name, t in (("idx_pos", idx_pos), ("idx_zero", idx_zero)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    if n == 0 or m == 0 or blocks == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=a.device)
    out = torch.empty((n, m), dtype=torch.float32, device=a.device)
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    bn, cb, per, splits = launch_config(n, blocks, m, c, _sm_count(index))
    ws = (torch.empty((splits, n, m), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(a.data_ptr(), idx_pos.data_ptr(), idx_zero.data_ptr(),
                     w_scale.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(),
                     n, blocks, m, c, bn, cb, per, splits, stream)
    if err != 0:
        raise RuntimeError(f"tsar_lut kernel launch failed: CUDA error {err}")
    LAUNCHES["tsar_lut"] += 1
    return out
