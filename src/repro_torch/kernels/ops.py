"""Public wrappers for the hand-written kernels (port of
``repro/kernels/ops.py``): ``tsar_matmul``, ``tsar_sparse_matmul``,
``tsar_sparse_padded_matmul`` and ``tsar_lut_gemv``.

Each flattens leading dims, quantizes the activations per token (all but
``tsar_lut_gemv``, which takes them in float32), pads only as far as its
CUDA kernel needs, launches, and slices the padding off.  The reference's
8/128 tile alignment is a TPU constraint and does not apply here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import ternary
from repro_torch.kernels import tsar_lut as _lut_kernel
from repro_torch.kernels import tsar_matmul as _mxu_kernel
from repro_torch.kernels import tsar_sparse as _sparse_kernel

DATAFLOWS = ("AP", "OP")


def _pad_to(x: torch.Tensor, dim: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - dim) + 1] = pad   # F.pad lists dims last-first
    return F.pad(x, widths)


def tsar_matmul(x: torch.Tensor, tw: ternary.TernaryWeights, *,
                dataflow: str = "AP") -> torch.Tensor:
    """BitLinear matmul through the packed-decode kernel.

    ``x`` (..., K) float -> (..., M) float32: per-token int8 quantization,
    packed-ternary int8 matmul with in-register decode, fused dequant.

    ``dataflow`` keeps the reference's AP (activation-persistent) / OP
    (output-persistent) argument, validated and otherwise unused: the CUDA
    kernel is one launch of one wave in which each cluster of CTAs owns one
    column tile and all N rows of it (up to 32; a grid over 32-row tiles
    above), so every plane byte and every activation is read once per column
    tile whatever the order, and there is no n/m raster order to choose.
    """
    if dataflow not in DATAFLOWS:
        raise ValueError(f"dataflow must be AP or OP, got {dataflow!r}")
    k, m = tw.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} features, weights expect {k}")
    lead = tuple(x.shape[:-1])
    a_q, a_scale = ternary.quantize_activations(x.reshape(-1, k).to(torch.float32))
    return tsar_matmul_quantized(a_q, a_scale, tw).reshape(lead + (m,))


def tsar_matmul_quantized(a_q: torch.Tensor, a_scale: torch.Tensor,
                          tw: ternary.TernaryWeights) -> torch.Tensor:
    """:func:`tsar_matmul` from activations already quantized: ``a_q``
    (N, K) int8 and ``a_scale`` (N, 1) float32 -> (N, M) float32."""
    # Padded K columns are zero activations, so whatever the plane tail
    # decodes to contributes nothing (the kernel's wrapper pads further).
    a_q = _pad_to(a_q, 1, 8)
    return _mxu_kernel.tsar_matmul_packed(a_q.contiguous(), a_scale.contiguous(),
                                          tw.sign_plane.contiguous(),
                                          tw.zero_plane.contiguous(), tw.scale.contiguous())


def tsar_sparse_matmul(x: torch.Tensor, bst) -> torch.Tensor:
    """BitLinear matmul through the compacted-pool zero-skip kernel.

    ``x`` (..., K) float -> (..., M) float32, with the weights a
    ``sparse.format.BlockSparseTernary``: per-token int8 quantization, K
    zero-padded to ``kb * bk`` (pad channels meet zero-padded weight tails or
    dead blocks), the kernel walks each m-strip's live blocks only, and the
    padded M columns are sliced off.  Bit-identical to :func:`tsar_matmul`.
    """
    k, m = bst.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} features, weights expect {k}")
    bk, bm = bst.block_shape
    kb, mb = bst.grid
    lead = tuple(x.shape[:-1])
    a_q, a_scale = ternary.quantize_activations(x.reshape(-1, k).to(torch.float32))
    a_q = _pad_to(a_q, 1, kb * bk)
    wsc = _pad_to(bst.scale, 0, mb * bm)
    y = _sparse_kernel.tsar_sparse_matmul_packed(
        a_q.contiguous(), a_scale, bst.sign_pool, bst.zero_pool, bst.kids,
        bst.slots, bst.counts, wsc.contiguous())
    return y[:, :m].reshape(lead + (m,))


def tsar_sparse_padded_matmul(x: torch.Tensor, pbst) -> torch.Tensor:
    """BitLinear matmul through the padded-pool zero-skip kernel.

    ``x`` (..., K) float -> (..., M) float32, with the weights a
    ``sparse.format.PaddedBlockSparseTernary``: per-token int8 quantization
    (once), K zero-padded to ``kb * bk``, the kernel walks each m-strip's
    live blocks only, and the padded M columns are sliced off.

    The reference computes its activation-liveness map (all-zero (bn, bk)
    activation tiles) here, before the call.  The port's kernel computes it
    from the activation tile it stages anyway, which saves a separate pass
    of tensor ops in a host-bound step; the skip drops exact int32 zeros,
    so where it is computed does not change the result.
    """
    k, m = pbst.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} features, weights expect {k}")
    bk, bm = pbst.block_shape
    kb, mb = pbst.grid
    lead = tuple(x.shape[:-1])
    a_q, a_scale = ternary.quantize_activations(x.reshape(-1, k).to(torch.float32))
    a_q = _pad_to(a_q, 1, kb * bk)        # padded K channels are zero
    wsc = _pad_to(pbst.scale, 0, mb * bm)
    y = _sparse_kernel.tsar_sparse_padded_matmul_packed(
        a_q.contiguous(), a_scale, pbst.sign_pool, pbst.zero_pool, pbst.kids,
        pbst.slots, pbst.counts, wsc.contiguous())
    return y[:, :m].reshape(lead + (m,))


def tsar_lut_gemv(x: torch.Tensor, idx_pos: torch.Tensor, idx_zero: torch.Tensor,
                  w_scale: torch.Tensor, c: int = 4) -> torch.Tensor:
    """BitLinear matmul through the shared-LUT kernel.

    ``x`` (..., K) float -> (..., M) float32, with (ceil(K/c), M) uint8
    encodings from ``core.ternary.pack_indices``.  The activations stay
    float32 (no quantization); K is zero-padded to ``blocks * c`` only
    (padded channels build all-zero LUT entries, so any index adds 0).  The
    kernel's wrapper pads further where its TMA copies need it.
    """
    blocks, m = idx_pos.shape
    k = x.shape[-1]
    if k > blocks * c:
        raise ValueError(f"x has {k} features, indices cover {blocks * c}")
    lead = tuple(x.shape[:-1])
    x2 = _pad_to(x.reshape(-1, k).to(torch.float32), 1, blocks * c)
    y = _lut_kernel.tsar_lut_gemv(x2.contiguous(), idx_pos.contiguous(),
                                  idx_zero.contiguous(),
                                  w_scale.to(torch.float32).contiguous(), c=c)
    return y.reshape(lead + (m,))
