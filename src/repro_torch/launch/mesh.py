"""Production mesh (port of ``repro/launch/mesh.py``), as a description
and as a ``torch.distributed`` device mesh.

A :class:`Mesh` is its axis names and sizes, nothing more: building one
creates no process group and touches no device, so the dry-run and the
sharding rules can size a 256- or 512-device layout on one machine.  The
reference's ``jax.make_mesh`` shapes are kept so that specs compare one for
one.

To run on one, :func:`init_process_group` joins the processes that
``torchrun`` started (NCCL for CUDA, one rank per card; gloo for the CPU)
and :func:`device_mesh` lays a :class:`Mesh` over them as a
``torch.distributed`` ``DeviceMesh`` with the same axis names and sizes.
:func:`fake_world` makes this process rank 0 of a world of ``mesh.size``
ranks that exist only in name, so that the dry-run can trace one device's
share of a step on the meta device.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


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


def describe(device_mesh) -> Mesh:
    """The :class:`Mesh` of a ``DeviceMesh`` (its axis names and sizes)."""
    return Mesh(tuple(device_mesh.shape), tuple(device_mesh.mesh_dim_names))


def init_process_group(device: str | torch.device = "cuda", *, init_method: str = "env://",
                       rank: int | None = None, world_size: int | None = None,
                       timeout: datetime.timedelta = datetime.timedelta(minutes=10)
                       ) -> torch.device:
    """Join the process group of a ``torchrun`` launch and return this
    rank's device.

    The backend follows ``device``: NCCL for ``cuda`` (rank r on
    ``cuda:LOCAL_RANK``), gloo for ``cpu``.  A failure to start NCCL raises;
    CUDA tensors never fall back to gloo.  ``rank`` and ``world_size``
    default to the ``RANK`` and ``WORLD_SIZE`` that ``torchrun`` sets;
    ``init_method`` may name a shared file (``file://...``) instead of the
    ``MASTER_ADDR``/``MASTER_PORT`` rendezvous.  Joining twice is a no-op.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group('cuda'): torch.cuda.is_available() is False")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {str(device)!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is already "
                               f"initialized; {dev} needs {backend}")
        return dev
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", "1")) if world_size is None
                  else world_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout,
                            device_id=dev if backend == "nccl" else None)
    return dev


def device_mesh(mesh: Mesh, device: str | torch.device = "cuda"):
    """A ``DeviceMesh`` over the initialized process group with ``mesh``'s
    axis names and sizes; the world must hold exactly ``mesh.size`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != mesh.size:
        raise ValueError(f"mesh {dict(mesh.shape)} needs {mesh.size} processes, "
                         f"the world has {world}")
    return init_device_mesh(torch.device(device).type, mesh.dims,
                            mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def fake_world(mesh: Mesh, device_type: str = "cuda", rank: int = 0):
    """This process as ``rank`` of a world of ``mesh.size`` ranks, and the
    ``DeviceMesh`` of ``mesh`` over it, for the extent of the ``with``.

    The world is ``torch.distributed``'s ``fake`` backend (with its
    ``FakeStore``, from ``torch.testing``): every rank but this one exists
    only in name, and a collective returns at once with its output as it
    came (its shape is right, its values are not).  Meant for meta tensors,
    which hold no values: the dry-run traces one rank's share of a step
    through the same code that runs across real ranks (rank 0, and the last
    rank too where a cell's dims do not divide its axes).  ``device_type`` is
    the mesh's: DTensor picks some collectives by it (a ``cpu`` mesh, gloo's,
    has no all-to-all and all-gathers instead); no device of that type is
    needed.  Raises if a process group is already initialized (it would be
    replaced); the fake group is destroyed on the way out.
    """
    if dist.is_initialized():
        raise RuntimeError(f"a {dist.get_backend()} process group of "
                           f"{dist.get_world_size()} ranks is initialized; a fake world "
                           "would replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} is outside a world of {mesh.size}")
    _clear_sharding_cache()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=mesh.size)
    try:
        yield device_mesh(mesh, device_type)
    finally:
        dist.destroy_process_group()
        _clear_sharding_cache()


def _clear_sharding_cache() -> None:
    """Empty DTensor's caches of sharding propagations (the Python one, and
    the native dispatch's where the torch version has one).  Their entries
    hold the output specs' ``DeviceMesh``, and a mesh of another world
    compares equal (same layout and names) while its process groups' names
    are that world's rank's: a later world as another rank would run
    collectives on groups it does not have."""
    from torch.distributed.tensor import DTensor

    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if native is not None:
        native()
