"""Ternary quantization and 2-bit bitplane packing (port of
``repro/core/ternary.py``).

* ``absmean`` ternarization of latent fp weights (BitNet-b1.58 recipe).
* Bitplane packing: the *sign* plane (bit=1 where w == -1) and the *zero*
  plane (bit=1 where w == 0) are each packed 8 weights/byte along K,
  LSB-first, so 2 bits/weight cross device memory.  A ragged K tail pads the
  zero plane with 1s so pad positions decode to weight 0.
* Per-token int8 activation quantization (absmax).

``torch.round`` rounds half to even, as ``jnp.round`` does, so the integer
paths here are bit-identical to the reference.  Integer products of int8
tensors must accumulate in int32: ``int8 @ int8`` on the CPU returns int8
and wraps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Number of weights packed per byte in a bitplane.
PACK = 8


class TernaryWeights(NamedTuple):
    """Frozen, packed ternary weight tensor, logical layout ``(K, M)``."""

    sign_plane: torch.Tensor   # uint8 (ceil(K/8), M)  bit=1 where w == -1
    zero_plane: torch.Tensor   # uint8 (ceil(K/8), M)  bit=1 where w == 0
    scale: torch.Tensor        # f32   (M,) per-output-channel dequant scale
    shape: tuple               # logical (K, M)


def absmean_ternarize(w: torch.Tensor, eps: float = 1e-6
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """BitNet-b1.58 absmean ternarization.

    ``w`` fp latent weights; the last two dims are the (K, M) matrix, any
    leading dims are batch (stacked layers).  Returns ``(t, scale)`` with
    ``t in {-1,0,+1}`` (dtype of ``w``) and a per-(batch, output-channel)
    scale such that ``w ~= t * scale``.
    """
    gamma = torch.mean(torch.abs(w), dim=(-2, -1), keepdim=True) + eps
    t = torch.clamp(torch.round(w / gamma), -1, 1)
    num = torch.sum(w * t, dim=-2)
    den = torch.sum(t * t, dim=-2) + eps
    return t, num / den


def _pack_bits(bits: torch.Tensor, pad_value: int = 0) -> torch.Tensor:
    """Pack a ``{0,1}`` tensor along dim 0: (K, ...) -> (ceil(K/8), ...)
    uint8, bit i of byte j holding element ``j*8 + i`` (LSB-first).  A
    ragged tail is padded with ``pad_value`` bits."""
    k = bits.shape[0]
    bits = bits.to(torch.uint8)
    pad = (-k) % PACK
    if pad:
        tail = torch.full((pad,) + tuple(bits.shape[1:]), pad_value,
                          dtype=torch.uint8, device=bits.device)
        bits = torch.cat([bits, tail], dim=0)
    kp = k + pad
    b = bits.reshape((kp // PACK, PACK) + tuple(bits.shape[1:]))
    shifts = torch.arange(PACK, dtype=torch.uint8, device=bits.device)
    shifts = shifts.reshape((1, PACK) + (1,) * (bits.ndim - 1))
    return torch.sum(b << shifts, dim=1).to(torch.uint8)


def _unpack_bits(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`_pack_bits` -> int8 {0,1} of shape (k, ...)."""
    shifts = torch.arange(PACK, dtype=torch.uint8, device=packed.device)
    shifts = shifts.reshape((1, PACK) + (1,) * (packed.ndim - 1))
    bits = (packed[:, None] >> shifts) & 1
    kp = packed.shape[0] * PACK
    return bits.reshape((kp,) + tuple(packed.shape[1:]))[:k].to(torch.int8)


def pack(t: torch.Tensor, scale: torch.Tensor | None = None) -> TernaryWeights:
    """Pack a ternary (K, M) matrix into 2-bit bitplanes."""
    if t.ndim != 2:
        raise ValueError(f"pack expects a 2-D (K, M) matrix, got {tuple(t.shape)}")
    k, m = t.shape
    if scale is None:
        scale = torch.ones((m,), dtype=torch.float32, device=t.device)
    return TernaryWeights(
        sign_plane=_pack_bits(t < 0),
        zero_plane=_pack_bits(t == 0, pad_value=1),   # ragged tail decodes to 0
        scale=scale.to(torch.float32),
        shape=(k, m),
    )


def decode_planes(sign_plane: torch.Tensor, zero_plane: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Two (ceil(K/8), ...) planes -> int8 ternary (k, ...):
    ``(1 - 2*sign) * (1 - zero)``."""
    sign = _unpack_bits(sign_plane, k)
    zero = _unpack_bits(zero_plane, k)
    return (1 - 2 * sign) * (1 - zero)


def unpack(tw: TernaryWeights, dtype=torch.int8) -> torch.Tensor:
    """Unpack bitplanes back to a dense ternary (K, M) matrix (no scale)."""
    return decode_planes(tw.sign_plane, tw.zero_plane, tw.shape[0]).to(dtype)


def quantize_activations(a: torch.Tensor, eps: float = 1e-6
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax int8 quantization: ``a`` (..., K) float ->
    (q int8 (..., K), scale f32 (..., 1)) with ``a ~= q * scale``."""
    absmax = torch.amax(torch.abs(a), dim=-1, keepdim=True)
    scale = (absmax / 127.0 + eps).to(torch.float32)
    q = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int8)
    return q, scale


def ternary_density(t: torch.Tensor) -> torch.Tensor:
    """Fraction of non-zero weights (over the last two dims)."""
    return torch.mean((t != 0).to(torch.float32), dim=(-2, -1))
