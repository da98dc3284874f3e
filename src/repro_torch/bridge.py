"""Carry a reference (JAX package) params tree across to the port.

``params_from_reference`` takes the reference tree with its leaves already
turned into numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference side; this module imports no JAX) and returns the same tree of
torch tensors, leaf for leaf: latent ``{'w'}``, frozen ``{'sign','zero',
'scale','density'}`` with the padded-pool leaves ``sp_sign sp_zero sp_map
sp_kids sp_slots sp_counts block_density`` where the freeze emitted them,
dense ``{'wd'}`` and norm ``{'g'}`` dicts, with the stacked leading ``L``
axis kept.  The uint8 planes and pools and the int32 schedules come across
byte for byte, so a test can freeze in JAX and serve the same weights in
both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_reference(tree, device="cuda"):
    """numpy-leaved reference params -> torch params on ``device``."""
    dev = resolve_device(device)

    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype == np.float64:
            raise TypeError(f"{path}: float64 leaf; the reference runs in float32")
        return torch.from_numpy(np.array(arr, order="C")).to(dev)   # a writable copy

    return walk(tree, "")
