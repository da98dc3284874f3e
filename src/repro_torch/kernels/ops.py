"""Public wrapper for the packed-ternary kernel (port of
``repro/kernels/ops.py::tsar_matmul``).

It flattens leading dims, quantizes the activations per token, pads only as
far as the CUDA kernel needs (K to a multiple of 8, M to a multiple of 4),
launches, and slices the padding off.  The reference's 8/128 tile alignment
is a TPU constraint and does not apply here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import ternary
from repro_torch.kernels import tsar_matmul as _mxu_kernel

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
    (output-persistent) argument.  The first CUDA kernel has one launch
    order for both: every CTA covers all N rows of its column tile (N <= 32
    on the serving path), so there is no n/m raster order to choose yet.
    """
    if dataflow not in DATAFLOWS:
        raise ValueError(f"dataflow must be AP or OP, got {dataflow!r}")
    k, m = tw.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} features, weights expect {k}")
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, k).to(torch.float32)
    a_q, a_scale = ternary.quantize_activations(x2)
    # Padded K columns are zero activations, so whatever the plane tail
    # decodes to contributes nothing; padded M columns are sliced off.
    a_q = _pad_to(a_q, 1, 8)
    sign = _pad_to(tw.sign_plane, 1, 4)
    zero = _pad_to(tw.zero_plane, 1, 4)
    wsc = _pad_to(tw.scale, 0, 4)
    y = _mxu_kernel.tsar_matmul_packed(a_q.contiguous(), a_scale, sign.contiguous(),
                                       zero.contiguous(), wsc.contiguous())
    return y[:, :m].reshape(lead + (m,))
