"""Carry reference (JAX package) weights across to the port.

* ``params_from_reference`` takes the reference params tree with its leaves
  already turned into numpy arrays (``jax.tree.map(np.asarray, params)`` on
  the reference side) and returns the same tree of torch tensors, leaf for
  leaf: latent ``{'w'}``, frozen ``{'sign','zero','scale','density'}`` with
  the padded-pool leaves ``sp_sign sp_zero sp_map sp_kids sp_slots
  sp_counts block_density`` where the freeze emitted them, dense ``{'wd'}``
  and norm ``{'g'}`` dicts, with the stacked leading ``L`` axis kept.
* ``frozen_from_reference`` takes one reference ``FrozenBitLinear`` (its
  arrays numpy or anything ``np.asarray`` reads) and returns the port's:
  planes, scale, LUT indices, the compacted and padded sidecars and the
  measured densities.

This module imports no JAX.  Every uint8 plane, index array and pool and
every int32 schedule comes across byte for byte, so a test can freeze in
JAX and serve the same weights in both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(node, dev: torch.device, path: str) -> torch.Tensor:
    arr = np.asarray(node)
    if arr.dtype == np.float64:
        raise TypeError(f"{path}: float64 leaf; the reference runs in float32")
    return torch.from_numpy(np.array(arr, order="C")).to(dev)   # a writable copy


def params_from_reference(tree, device="cuda"):
    """numpy-leaved reference params -> torch params on ``device``."""
    dev = resolve_device(device)

    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return _tensor(node, dev, path)

    return walk(tree, "")


def frozen_from_reference(fz, device="cuda"):
    """A reference ``FrozenBitLinear`` -> ``repro_torch.core.bitlinear.
    FrozenBitLinear`` on ``device``."""
    from repro_torch.core import bitlinear, ternary
    from repro_torch.sparse import format as sparse_format

    dev = resolve_device(device)

    def arrays(obj, names, path):
        return {n: _tensor(getattr(obj, n), dev, f"{path}.{n}") for n in names}

    def ints(seq) -> tuple:
        return tuple(int(d) for d in seq)

    p = fz.packed
    packed = ternary.TernaryWeights(**arrays(p, ("sign_plane", "zero_plane", "scale"),
                                             "packed"), shape=ints(p.shape))
    pool = ("sign_pool", "zero_pool", "block_map", "occupancy", "scale", "kids",
            "slots", "counts")
    sparse = padded = None
    if fz.sparse is not None:
        s = fz.sparse
        sparse = sparse_format.BlockSparseTernary(
            **arrays(s, pool, "sparse"), shape=ints(s.shape),
            block_shape=ints(s.block_shape), n_live=int(s.n_live), s_max=int(s.s_max))
    if fz.padded is not None:
        q = fz.padded
        padded = sparse_format.PaddedBlockSparseTernary(
            **arrays(q, pool, "padded"), shape=ints(q.shape),
            block_shape=ints(q.block_shape), max_live=int(q.max_live),
            s_steps=int(q.s_steps))
    return bitlinear.FrozenBitLinear(
        packed=packed, **arrays(fz, ("idx_pos", "idx_zero"), "frozen"), c=int(fz.c),
        sparse=sparse, padded=padded,
        density=None if fz.density is None else float(fz.density),
        block_density=None if fz.block_density is None else float(fz.block_density))
