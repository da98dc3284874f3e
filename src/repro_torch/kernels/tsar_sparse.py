"""Block-sparse packed-ternary matmul: the hand-written Hopper kernels and
their plain version.

Two entry points of ``repro_torch/csrc/tsar_sparse.cu`` (built with
``nvcc`` for ``sm_90a`` on first use and bound through ``ctypes``):

* :func:`tsar_sparse_padded_matmul_packed` replaces
  ``src/repro/kernels/tsar_sparse.py::tsar_sparse_padded_matmul_packed``
  (the ``pallas_call`` at :223, body ``_kernel_2d`` at :135): the padded
  pool of the serving step, with the activation-tile skip;
* :func:`tsar_sparse_matmul_packed` replaces
  ``src/repro/kernels/tsar_sparse.py::tsar_sparse_matmul_packed`` (the
  ``pallas_call`` at :122, body ``_kernel`` at :46): the compacted pool of
  ``core.bitlinear`` (``max(n_live, 1)`` slots, a ``max(s_max, 1)`` walk),
  without the activation skip, as the TPU kernel has none.

What bounds them: at N = 4 or 20 rows the call is bound by the plane bytes
of the live blocks, ``sum_j counts[j] * 2 * (bk/8) * bm``, plus the
activations, the output, the scales and the schedule.  Each m-strip walks
only its ``counts[j]`` live blocks, gathering each pool slot by index.  The
skips drop exact int32 zeros, so both outputs are bit-identical to
``tsar_matmul`` on the decoded matrix and to the one plain version.

On a CPU tensor each wrapper computes the plain version; on a CUDA tensor
it launches its kernel or raises.  ``LAUNCHES`` counts each entry point's
launches apart, and only those.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import ternary
from repro_torch.kernels import tsar_matmul as _mxu_kernel

# Launch counters; chip_smoke.py zeroes them before driving a path.
LAUNCHES = {"tsar_sparse_padded": 0, "tsar_sparse": 0}

_TILE_COLS = 64          # kTileCols in the CUDA source


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


# C signature of both entry points: 10 pointers (a_q, a_scale, sign_pool,
# zero_pool, kids, slots, counts, w_scale, out, workspace), 8 ints (n, kp,
# bk, bm, mb, s_steps, bn, splits), the stream.
_PROTO = ctypes.CFUNCTYPE(ctypes.c_int, *([ctypes.c_void_p] * 10),
                          *([ctypes.c_int] * 8), ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    from repro_torch.kernels import _build

    return _PROTO((symbol, _build.load("tsar_sparse")))


def launch_config(n: int, bm: int, mb: int, s_steps: int,
                  sm_count: int) -> tuple[int, int]:
    """(rows per CTA, walk splits): the row tile of ``tsar_matmul`` and
    enough splits of each strip's live walk for about two CTAs per SM."""
    bn = _mxu_kernel.row_tile(n)
    tiles = mb * -(-bm // _TILE_COLS) * -(-n // bn)
    return bn, min(s_steps, max(1, -(-2 * sm_count // tiles)))


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


def _launch(symbol: str, counter: str, a_q, a_scale, sign_pool, zero_pool,
            kids, slots, counts, w_scale) -> torch.Tensor:
    """Check the inputs, then the plain version on the CPU, or one launch of
    the CUDA entry point ``symbol`` counted under ``LAUNCHES[counter]``."""
    _check(a_q, a_scale, sign_pool, zero_pool, kids, slots, counts, w_scale)
    if a_q.device.type == "cpu":
        return tsar_sparse_padded_plain(a_q, a_scale, sign_pool, zero_pool,
                                        kids, slots, counts, w_scale)
    if a_q.device.type != "cuda":
        raise ValueError(f"unsupported device {a_q.device}")
    n, kp = a_q.shape
    _, k8, bm = sign_pool.shape
    mb, s_steps = kids.shape
    if bm % 4:
        raise ValueError(f"the CUDA kernel needs bm % 4 == 0, got bm={bm}")
    for name, t in (("sign_pool", sign_pool), ("zero_pool", zero_pool)):
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned")
    out = torch.empty((n, mb * bm), dtype=torch.float32, device=a_q.device)
    if n == 0 or mb == 0:
        return out
    index = a_q.device.index if a_q.device.index is not None else torch.cuda.current_device()
    bn, splits = launch_config(n, bm, mb, s_steps, _sm_count(index))
    ws = (torch.empty((n, mb * bm), dtype=torch.int32, device=a_q.device)
          if splits > 1 else None)
    with torch.cuda.device(a_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(symbol)(a_q.data_ptr(), a_scale.data_ptr(), sign_pool.data_ptr(),
                             zero_pool.data_ptr(), kids.data_ptr(), slots.data_ptr(),
                             counts.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
                             None if ws is None else ws.data_ptr(),
                             n, kp, 8 * k8, bm, mb, s_steps, bn, splits, stream)
    if err != 0:
        raise RuntimeError(f"{counter} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
    return out


def tsar_sparse_padded_matmul_packed(a_q: torch.Tensor, a_scale: torch.Tensor,
                                     sign_pool: torch.Tensor, zero_pool: torch.Tensor,
                                     kids: torch.Tensor, slots: torch.Tensor,
                                     counts: torch.Tensor,
                                     w_scale: torch.Tensor) -> torch.Tensor:
    """(N, Kp) int8 x padded block pool -> (N, mb*bm) float32.

    ``Kp = kb * bk`` (zero-padded), pools (max_live, bk/8, bm) uint8, the
    schedule ``kids``/``slots`` (mb, s_steps) and ``counts`` (mb,) int32,
    ``a_scale`` (N, 1) and ``w_scale`` (mb*bm,) float32.  On CUDA the kernel
    needs ``bm % 4 == 0`` and 4-byte-aligned pools.
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
