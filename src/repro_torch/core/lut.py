"""The memory-LUT baseline (port of part of ``repro/core/lut.py``).

Only what the registry's plain ``memory_lut`` lowering needs: the base-3
LUT indices of a ternary matrix and the gather against a materialised
3^c-entry table per activation block (the T-MAC / bitnet.cpp TL-2 dataflow
the paper beats).  The shared-LUT ``tsar_lut`` family comes with the
``core/bitlinear`` slice.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _ternary_patterns(c: int) -> tuple:
    """Every ternary block pattern, (3^c, c) as nested tuples of {-1,0,+1};
    pattern p has digit i = (p // 3^i) % 3 - 1."""
    return tuple(tuple((p // 3 ** i) % 3 - 1 for i in range(c)) for p in range(3 ** c))


def ternary_lut_indices(t: torch.Tensor, c: int) -> torch.Tensor:
    """Base-3 encode ternary weights (K, M) -> (K//c, M) int32 LUT indices."""
    k, m = t.shape
    blocks = t.reshape(k // c, c, m).to(torch.int32) + 1        # {0,1,2}
    pows = (3 ** torch.arange(c, dtype=torch.int32, device=t.device)).reshape(1, c, 1)
    return torch.sum(blocks * pows, dim=1, dtype=torch.int32)


def memory_lut_precompute(a: torch.Tensor, c: int) -> torch.Tensor:
    """The materialised ternary LUT: (..., K) -> (..., K//c, 3^c)."""
    k = a.shape[-1]
    blocks = a.reshape(tuple(a.shape[:-1]) + (k // c, c))
    pat = torch.tensor(_ternary_patterns(c), dtype=a.dtype, device=a.device)
    return blocks @ pat.T


def memory_lut_matmul(a: torch.Tensor, lut_idx: torch.Tensor, c: int,
                      w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Gather each block's LUT entry per output column and sum over blocks:
    (..., K) x (K//c, M) indices -> (..., M)."""
    lut = memory_lut_precompute(a, c)                    # (..., B, 3^c)
    ix = lut_idx.long().expand(tuple(lut.shape[:-1]) + (lut_idx.shape[-1],))
    y = torch.take_along_dim(lut, ix, dim=-1).sum(dim=-2)
    if w_scale is not None:
        y = y * w_scale
    return y
