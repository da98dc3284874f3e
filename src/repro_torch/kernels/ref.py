"""Plain-PyTorch oracles for the packed-ternary kernels (port of
``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core import ternary


def ternary_matmul_ref(a: torch.Tensor, t: torch.Tensor,
                       w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Dense fp32 oracle: (..., K) x ternary (K, M) -> (..., M)."""
    y = a.to(torch.float32) @ t.to(torch.float32)
    if w_scale is not None:
        y = y * w_scale.to(torch.float32)
    return y


def packed_matmul_ref(a: torch.Tensor, tw: ternary.TernaryWeights) -> torch.Tensor:
    """Oracle for the packed path: unpack bitplanes, dense matmul, dequant."""
    return ternary_matmul_ref(a, ternary.unpack(tw), tw.scale)


def quantized_matmul_ref(a: torch.Tensor, tw: ternary.TernaryWeights) -> torch.Tensor:
    """Oracle with the exact int8-quantized activation pipeline the kernel
    implements (quant -> integer matmul -> dequant).  The integer sum runs
    in float64, exact for any K the models use."""
    a_q, a_scale = ternary.quantize_activations(a.to(torch.float32))
    t = ternary.unpack(tw, torch.float64)
    acc = a_q.to(torch.float64) @ t
    return acc.to(torch.float32) * a_scale * tw.scale


def padded_sparse_matmul_ref(a: torch.Tensor, pbst) -> torch.Tensor:
    """Oracle for the padded-pool zero-skip path: decode the pool back to a
    dense ternary matrix through its block map, then run the exact
    quantized pipeline.  The sparse kernel must match it bit for bit
    (skipped blocks are exact int32 zeros)."""
    from repro_torch.sparse import format as sparse_format

    t = sparse_format.padded_to_ternary(pbst)
    return quantized_matmul_ref(a, ternary.pack(t, pbst.scale))


def block_sparse_matmul_ref(a: torch.Tensor, bst) -> torch.Tensor:
    """Oracle for the compacted zero-block-skipping path: decode the pool
    back to a dense ternary matrix, then run the exact quantized pipeline.
    The compacted sparse kernel must match it bit for bit."""
    from repro_torch.sparse import format as sparse_format

    t = sparse_format.to_ternary(bst)
    return quantized_matmul_ref(a, ternary.pack(t, bst.scale))
