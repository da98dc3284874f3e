"""The H100's published peaks, the least time of one ternary projection,
and the model FLOPs of the tokens a step processes.

``bound`` is a copy of ``chip_smoke.py``'s: the larger of the bytes one
``tsar_matmul`` call must move (planes K*M/4, int8 activations N*K, float32
activation scales 4N, float32 output 4*N*M, float32 weight scales 4M) over
HBM bandwidth, and its int8 operations 2*N*K*M over the int8 tensor-core
peak.  Model FLOPs count the work the tokens need, not what the eager step
spends: 2 x the projection weights per token, 4 x context x heads x
head_dim per layer and token for attention (scores and the weighted sum
over the token's causal context), and 2 x d x vocab per emitting row for
the head.
"""
from __future__ import annotations

from h100bench import weights

# H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM3 bytes/s and int8
# tensor-core ops/s.  The projections run int8 products, so the int8 peak
# is the model step's peak.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def bound_s(n: int, k: int, m: int) -> float:
    """Least time (s) of one N-row (K, M) projection."""
    nbytes = k * m / 4 + n * k + 4 * n + 4 * n * m + 4 * m
    return max(nbytes / HBM_BYTES_PER_S, 2 * n * k * m / INT8_OPS_PER_S)


def step_bound_s(c: dict, n: int) -> float:
    """Least time (s) of every projection of one step of N planned rows."""
    return weights.dims(c)["layers"] * sum(bound_s(n, k, m) for _, k, m in weights.projections(c))


def flops(c: dict, rows: int, context: int, emitted: int) -> float:
    """Model FLOPs of ``rows`` processed tokens whose causal contexts sum to
    ``context``, ``emitted`` of them scored by the head."""
    n = weights.dims(c)
    proj = sum(k * m for _, k, m in weights.projections(c))
    per_layer = 2 * proj * rows + 4 * context * n["h"] * n["dh"]
    return n["layers"] * per_layer + 2 * n["d"] * n["vocab"] * emitted
