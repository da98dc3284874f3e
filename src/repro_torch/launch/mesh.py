"""Production mesh, as a description (port of ``repro/launch/mesh.py``).

A mesh here is its axis names and sizes, nothing more: building one creates
no process group and touches no device, so the dry-run and the sharding
rules can size a 256- or 512-device layout on one machine.  The reference's
``jax.make_mesh`` shapes are kept so that specs compare one for one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes; ``shape[axis]``, ``axis_names`` and
    ``size`` read as a ``jax.sharding.Mesh``'s do."""

    dims: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.dims} does not match axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 256 devices (16 data x 16 model).  Multi-pod: 2 x 256.

    The 'pod' axis stacks data parallelism across pods; gradient all-reduce
    is the only collective that crosses it (see the sharding rules).
    """
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    """Arbitrary mesh for scaling studies and tests."""
    return Mesh(tuple(shape), tuple(axes))
