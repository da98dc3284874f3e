"""LUT-based ternary GEMM/GEMV algorithms (port of ``repro/core/lut.py``).

Three families, all plain PyTorch on the tensors' own device:

1. ``tsar_*``: the paper's method with the single shared LUT.  Binary LUTs
   are built on the fly from the activations and consumed at once; the
   identity is ::

       S[p]   = sum_i bit_i(p) * a_i                (2^c entries per block)
       <w,a>  = 2*S[idx_pos] + S[idx_zero] - sum(a)

   with ``idx_pos``/``idx_zero`` from :func:`repro_torch.core.ternary.
   pack_indices`.  The hand-written kernel ``csrc/tsar_lut.cu`` computes the
   same function; :func:`tsar_lut_matmul` is its plain version.
2. ``memory_lut_*``: the baseline the paper beats (T-MAC / bitnet.cpp TL-2):
   the full 3^c-entry ternary LUT is materialised and gathered.
3. ``dense_*`` and ``bitlinear_*``: the fp MAC and exact int8 pipelines.

Integer products never go through ``int8 @ int8`` (it wraps on the CPU and
is missing on CUDA): they accumulate in float64, which is exact for every K
the models use, then cast to float32 as the reference's int32 sums do.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import ternary


# ---------------------------------------------------------------------------
# Shared binary LUT construction ("TLUT" in the paper)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bit_rows(c: int) -> tuple:
    """(2^c, c) nested tuples with B[p][i] = bit_i(p)."""
    return tuple(tuple((p >> i) & 1 for i in range(c)) for p in range(1 << c))


def build_lut(a: torch.Tensor, c: int) -> torch.Tensor:
    """The shared binary LUT of every activation block: (..., K) ->
    (..., K//c, 2^c) with ``S[..., b, p] = sum_i bit_i(p) * a[..., b*c+i]``."""
    k = a.shape[-1]
    if k % c != 0:
        raise ValueError(f"K={k} not a multiple of block size c={c}")
    blocks = a.reshape(tuple(a.shape[:-1]) + (k // c, c))
    bits = torch.tensor(_bit_rows(c), dtype=a.dtype, device=a.device)
    return blocks @ bits.T


def block_sums(a: torch.Tensor, c: int) -> torch.Tensor:
    """Per-block activation sums -> (..., K//c)."""
    k = a.shape[-1]
    return a.reshape(tuple(a.shape[:-1]) + (k // c, c)).sum(dim=-1)


def _gather(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``S[..., b, idx[b, m]]`` -> (..., B, M)."""
    ix = idx.long().expand(tuple(s.shape[:-1]) + (idx.shape[-1],))
    return torch.take_along_dim(s, ix, dim=-1)


def _pad_k(a: torch.Tensor, kp: int) -> torch.Tensor:
    k = a.shape[-1]
    return a if kp == k else torch.nn.functional.pad(a, (0, kp - k))


# ---------------------------------------------------------------------------
# T-SAR on-the-fly LUT GEMV / GEMM
# ---------------------------------------------------------------------------

def tsar_lut_matmul(a: torch.Tensor, idx_pos: torch.Tensor, idx_zero: torch.Tensor,
                    c: int, w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``a`` (..., K) x encoded weights (K//c, M) -> (..., M) through the
    single-LUT identity.  A ragged K (``pack_indices`` zero-padded the tail
    block) is matched by zero-padding the activations: pad positions carry
    the ``idx_zero`` bit and contribute ``2*0 + a_i - a_i = 0``."""
    a = _pad_k(a, idx_pos.shape[-2] * c)
    s = build_lut(a, c)                          # (..., B, 2^c)
    tot = block_sums(a, c)                       # (..., B)
    y = (2.0 * _gather(s, idx_pos) + _gather(s, idx_zero)).sum(dim=-2) \
        - tot.sum(dim=-1, keepdim=True)
    if w_scale is not None:
        y = y * w_scale
    return y


def tsar_lut_matmul_twolut(a: torch.Tensor, idx_pos: torch.Tensor,
                           idx_zero: torch.Tensor, c: int,
                           w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """The paper-literal two-LUT form ``<w,a> = <w_D,a> - <w_S,a>``: the
    {-1,+1} LUT ``2*S - sum(a)`` gathered at ``idx_pos | idx_zero`` minus
    the {0,1} LUT ``S`` gathered at ``idx_zero`` (the oracle of the
    single-LUT form)."""
    s = build_lut(a, c)
    dense_lut = 2.0 * s - block_sums(a, c)[..., None]
    y = (_gather(dense_lut, torch.bitwise_or(idx_pos, idx_zero))
         - _gather(s, idx_zero)).sum(dim=-2)
    if w_scale is not None:
        y = y * w_scale
    return y


# ---------------------------------------------------------------------------
# Memory-LUT baseline (T-MAC / bitnet.cpp TL-2 dataflow)
# ---------------------------------------------------------------------------

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
    y = _gather(memory_lut_precompute(a, c), lut_idx).sum(dim=-2)
    if w_scale is not None:
        y = y * w_scale
    return y


# ---------------------------------------------------------------------------
# Dense reference paths
# ---------------------------------------------------------------------------

def dense_matmul(a: torch.Tensor, w: torch.Tensor,
                 w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Dense fp MAC baseline: (..., K) x (K, M)."""
    y = a @ w.to(a.dtype)
    if w_scale is not None:
        y = y * w_scale
    return y


def dense_int8_matmul(a_q: torch.Tensor, a_scale: torch.Tensor, t: torch.Tensor,
                      w_scale: torch.Tensor) -> torch.Tensor:
    """int8 activations x ternary weights: ``(a_q @ t) * a_scale * w_scale``
    with an exact integer sum (float64), cast to float32 like the
    reference's int32 accumulator."""
    acc = a_q.to(torch.float64) @ t.to(torch.float64)
    return acc.to(torch.float32) * a_scale * w_scale


def bitlinear_matmul_exact_int(a: torch.Tensor, t: torch.Tensor,
                               w_scale: torch.Tensor) -> torch.Tensor:
    """The whole BitLinear pipeline: quantize -> integer matmul -> dequant."""
    a_q, a_scale = ternary.quantize_activations(a)
    return dense_int8_matmul(a_q, a_scale, t, w_scale)


def bitlinear_matmul_fast(a: torch.Tensor, t: torch.Tensor,
                          w_scale: torch.Tensor) -> torch.Tensor:
    """The same pipeline with the integer sum carried in float32, which is
    exact while ``127 * K < 2**24`` (K below ~132k)."""
    a_q, a_scale = ternary.quantize_activations(a)
    acc = a_q.to(torch.float32) @ t.to(torch.float32)
    return acc * a_scale * w_scale
