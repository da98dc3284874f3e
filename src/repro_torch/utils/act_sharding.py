"""Activation sharding constraints (port of ``repro/utils/act_sharding.py``).

Model code calls :func:`constrain` at key activation points (q/k/v, the
attention context, the residual stream, logits, the MoE dispatch).  With no
mesh registered, or on a plain tensor, it is the identity, as the
reference's is with no mesh.  With a ``DeviceMesh`` registered
(:func:`set_mesh`) and a DTensor argument, it redistributes the DTensor to
the placements the reference's rules give (``x.redistribute``), the
counterpart of ``with_sharding_constraint``: DTensor propagates a sharding
through each op, and these points pin it where the reference pins XLA's.

Head-axis chain for attention tensors (B, S, H, Dh): shard H on 'model'
when divisible, else (queries only) the sequence axis, else replicate;
never Dh.
"""
from __future__ import annotations

import torch

_MESH = None


def set_mesh(mesh) -> None:
    """Register a ``torch.distributed`` ``DeviceMesh`` (None clears it)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def _size(mesh, axis: str) -> int:
    return mesh.shape[_names(mesh).index(axis)]


def _dax(mesh) -> tuple:
    return ("pod", "data") if "pod" in _names(mesh) else ("data",)


def _dsize(mesh) -> int:
    n = 1
    for a in _dax(mesh):
        n *= _size(mesh, a)
    return n


def spec_for(mesh, shape: tuple, kind: str) -> tuple:
    """The reference's constraint for an activation of ``shape``: one entry
    per dimension (None, an axis name or a tuple of them).

    kind: 'attn_q' / 'attn_kv' (B, S, H, Dh) | 'residual' (B, S, D) |
    'logits' (B, S, V) | 'vocab_rows' (V, D) | 'vocab_cols' (D, V) | 'moe'
    (B, E, C, D) | 'expert_weights' (E, K, M)."""
    ndim = len(shape)
    dsz, msz, dax = _dsize(mesh), _size(mesh, "model"), _dax(mesh)
    spec: list = [None] * ndim
    if kind in ("vocab_rows", "vocab_cols"):
        # Head weights at the matmul: vocab on 'model', d_model replicated.
        vax = 0 if kind == "vocab_rows" else 1
        if shape[vax] % msz == 0:
            spec[vax] = "model"
        return tuple(spec)
    if kind == "expert_weights" and ndim == 3:
        # Decoded (E, K, M) expert weights: expert-sharded, replicated over data.
        spec[0] = "model" if shape[0] % msz == 0 else None
        return tuple(spec)
    if shape[0] % dsz == 0:
        spec[0] = dax
    if kind in ("attn_q", "attn_kv") and ndim == 4:
        if shape[2] % msz == 0:
            spec[2] = "model"
        elif kind == "attn_q" and shape[1] > 1 and shape[1] % msz == 0:
            spec[1] = "model"
    elif kind == "logits":
        if shape[-1] % msz == 0:
            spec[-1] = "model"
    elif kind == "moe" and ndim == 4:
        if shape[1] % msz == 0:
            spec[1] = "model"
    # 'residual': batch-sharded, replicated on model (Megatron convention).
    return tuple(spec)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a plain tensor answers without importing
    ``torch.distributed.tensor``: this sits on every step's path)."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` redistributed to the reference's placements for ``kind`` (see
    :func:`spec_for`) when a mesh is registered and ``x`` is a DTensor on
    it; otherwise ``x`` itself."""
    mesh = _MESH
    if mesh is None or not is_dtensor(x) or x.device_mesh != mesh:
        return x
    from repro_torch.train.sharding import placements

    pl = placements(mesh, spec_for(mesh, tuple(x.shape), kind), x.ndim)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor ``x`` with dimension ``dim`` gathered onto every rank of
    the axes that shard it, still a DTensor; a plain tensor as it is.  For
    ops whose result would otherwise follow the split (see the callers)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    d = dim % x.ndim
    pl = tuple(Replicate() if pl == Shard(d) else pl for pl in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)

