"""Packed-ternary matmul: the hand-written Hopper kernel and its plain version.

Replaces ``src/repro/kernels/tsar_matmul.py::tsar_matmul_packed`` (the
``pallas_call`` at :124, body ``_kernel`` at :41).  The CUDA source is
``repro_torch/csrc/tsar_matmul.cu``; it is built with ``nvcc`` for
``sm_90a`` on first use and bound through ``ctypes``.

What bounds it: the serving step calls it at N = 4 (pure decode) or 20
(steps carrying prefill) rows, so it is bound by the 2-bit plane bytes,
K*M/4.  The kernel reads each plane byte once, decodes it to int8 weights in
registers and accumulates with ``__dp4a``; no int8 weight matrix ever reaches
device memory.  See the source for the launch layout.

On a CPU tensor :func:`tsar_matmul_packed` computes the plain version; on a
CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts the
launches (and only those), so a run can show the serving path went through
the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import ternary

# Launch counter; chip_smoke.py zeroes it before driving the serving path.
LAUNCHES = {"tsar_matmul": 0}

_COLS_PER_CTA = 64       # kBM in the CUDA source
_K_CHUNK = 256           # kKChunk in the CUDA source
_BN_CHOICES = (4, 8, 12, 16, 20, 24, 28, 32)   # row tiles compiled in the source


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


# C signature of tsar_matmul_packed: 7 pointers (a_q, a_scale, sign, zero,
# w_scale, out, workspace), 5 ints (n, kp, m, bn, splitk), the stream.
_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *([ctypes.c_void_p] * 7),
                          *([ctypes.c_int] * 5), ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _lib():
    from repro_torch.kernels import _build

    return _PROTO(("tsar_matmul_packed", _build.load("tsar_matmul")))


def row_tile(n: int) -> int:
    """Rows per CTA for ``n`` rows: the smallest compiled tile that covers
    ``n`` (a multiple of 4), or 32 and a grid over row tiles above that."""
    return next((b for b in _BN_CHOICES if n <= b), _BN_CHOICES[-1])


def launch_config(n: int, kp: int, m: int, sm_count: int) -> tuple[int, int]:
    """(rows per CTA, K splits) for an (n, kp) x (kp, m) problem: the row
    tile of :func:`row_tile` and enough K splits for about two CTAs per SM."""
    bn = row_tile(n)
    tiles = -(-m // _COLS_PER_CTA) * -(-n // bn)
    chunks = -(-kp // _K_CHUNK)
    split = min(chunks, max(1, -(-2 * sm_count // tiles)))
    per = -(-chunks // split)
    return bn, -(-chunks // per)


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


def tsar_matmul_packed(a_q: torch.Tensor, a_scale: torch.Tensor,
                       sign_plane: torch.Tensor, zero_plane: torch.Tensor,
                       w_scale: torch.Tensor) -> torch.Tensor:
    """(N, Kp) int8 x packed ternary (Kp/8, M) planes -> (N, M) float32.

    ``a_scale`` is (N, 1) float32, ``w_scale`` (M,) float32.  On CUDA the
    kernel needs ``M % 4 == 0`` and 4-byte-aligned planes (``ops`` pads M).
    """
    _check(a_q, a_scale, sign_plane, zero_plane, w_scale)
    if a_q.device.type == "cpu":
        return tsar_matmul_plain(a_q, a_scale, sign_plane, zero_plane, w_scale)
    if a_q.device.type != "cuda":
        raise ValueError(f"unsupported device {a_q.device}")
    n, kp = a_q.shape
    m = sign_plane.shape[1]
    if m % 4:
        raise ValueError(f"the CUDA kernel needs M % 4 == 0, got M={m}")
    for name, t in (("sign_plane", sign_plane), ("zero_plane", zero_plane)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    out = torch.empty((n, m), dtype=torch.float32, device=a_q.device)
    if n == 0:
        return out
    index = a_q.device.index if a_q.device.index is not None else torch.cuda.current_device()
    bn, split = launch_config(n, kp, m, _sm_count(index))
    ws = (torch.empty((n, m), dtype=torch.int32, device=a_q.device)
          if split > 1 else None)
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib()(a_q.data_ptr(), a_scale.data_ptr(), sign_plane.data_ptr(),
                     zero_plane.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(),
                     n, kp, m, bn, split, stream)
    if err != 0:
        raise RuntimeError(f"tsar_matmul kernel launch failed: CUDA error {err}")
    LAUNCHES["tsar_matmul"] += 1
    return out
