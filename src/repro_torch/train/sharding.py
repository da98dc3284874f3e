"""Partitioning rules: param/batch/cache specs for the 2-D/3-D mesh (port of
``repro/train/sharding.py``, the rules only).

A spec is a tuple with one entry per dimension: None (replicated), an axis
name, or a tuple of axis names; a 1-tuple is written as its one name, as
``jax.sharding.PartitionSpec`` normalizes it.  The rules are pure functions
over nested dicts of tensors (only shapes are read), so they size meta
trees as well as real ones.

Axes: ``data`` (+ ``pod`` stacked on top of it in multi-pod meshes) carry
batch; ``model`` carries tensor parallelism (attention heads / FFN hidden /
vocab) and expert parallelism (MoE expert axis).  Rules are path-based over
the param tree, so they survive arbitrary stacking (the leading layer axis
is always replicated).

* column-parallel in-projections (wq/wk/wv/w_gate/w_up/in_proj) shard M,
  row-parallel out-projections (wo/w_down/out_proj) shard K: the Megatron
  pattern, one all-reduce per block instead of four;
* embeddings shard the vocab axis; MoE expert stacks shard the expert axis
  (EP); routers/norms/scalars replicate;
* decode KV caches shard batch on 'data' when batch >= |data|, otherwise
  the sequence axis (sequence parallelism for a single long request).

Every rule takes a :class:`~repro_torch.launch.mesh.Mesh` description or a
``torch.distributed`` ``DeviceMesh``.  :func:`to_named` turns specs into
DTensor placements on a ``DeviceMesh`` (the reference's ``NamedSharding``)
and :func:`place` puts a tree's tensors there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.launch.mesh import Mesh, describe


def _as_mesh(mesh) -> Mesh:
    return mesh if isinstance(mesh, Mesh) else describe(mesh)


def spec(*entries) -> tuple:
    """A spec from its entries, 1-tuples written as their one name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def _data_axes(mesh: Mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axes_size(mesh: Mesh, axes: tuple) -> int:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


# --- param rules -----------------------------------------------------------

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj"}    # shard out-features
_ROW = {"wo", "w_down", "out_proj"}                        # shard in-features
_REPL = {"router", "frontend_proj", "conv_w", "conv_b", "A_log", "D",
         "dt_bias", "qn", "kn", "g"}


def is_expert_path(names: tuple) -> bool:
    """Whether the tree path ``names`` is that of a routed-expert stack's
    leaf (``moe`` / ``w_gate|w_up|w_down``, not the shared experts)."""
    return (len(names) >= 2 and names[-2] in ("w_gate", "w_up", "w_down")
            and "moe" in names and "shared" not in names)


def is_expert_stack(names: tuple, ndim: int) -> bool:
    """Whether the param leaf at tree path ``names`` (of ``ndim``
    dimensions) is a routed-expert stack (..., E, K, M)."""
    return ndim >= 3 and is_expert_path(names)


def param_spec(path: tuple, leaf, fsdp: bool = False) -> tuple:
    """Spec for one param leaf given its tree path (tuple of str).

    ``fsdp=True`` additionally shards one free axis over the data axes (the
    ``'__data__'`` placeholder, resolved by :func:`sanitize_spec`).
    """
    names = [p for p in path if isinstance(p, str)]
    leafname = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    ndim = leaf.ndim
    out = [None] * ndim

    if leafname == "embed":
        out = ["model", None]
        if fsdp:
            out[1] = "__data__"
        return spec(*out)
    if parent == "lm_head":
        out = [None, "model"]
        if fsdp:
            out[0] = "__data__"
        return spec(*out)
    if any(n in _REPL for n in names):
        return spec(*out)

    # Expert stacks: (..., E, K, M): the *expert* axis is the EP axis.
    if is_expert_stack(names, ndim):
        out[-3] = "model"
        if fsdp:
            out[-2] = "__data__"
    elif parent in _COL and ndim >= 2:
        out[-1] = "model"
        if fsdp:
            out[-2] = "__data__"
    elif parent in _ROW and ndim >= 2:
        out[-2] = "model"
        if fsdp:
            out[-1] = "__data__"
    return spec(*out)


def _map_with_path(fn, tree, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params, mesh: Mesh | None = None, fsdp: bool = False) -> dict:
    """Tree of specs matching ``params``.

    When ``mesh`` is given, specs are sanitized: any sharded axis whose size
    does not divide the mesh axes is dropped to replicated (whisper's vocab
    51865, head counts below |model|), and the '__data__' placeholder
    resolves to the mesh's (pod,)data axes.
    """
    mesh = None if mesh is None else _as_mesh(mesh)

    def one(path, leaf):
        s = param_spec(path, leaf, fsdp=fsdp)
        return s if mesh is None else sanitize_spec(mesh, tuple(leaf.shape), s)

    return _map_with_path(one, params)


def sanitize_spec(mesh: Mesh, shape: tuple, spec_in: tuple) -> tuple:
    """Drop shardings that don't divide; resolve the '__data__' placeholder."""
    mesh = _as_mesh(mesh)
    dax = _data_axes(mesh)
    dsz = _axes_size(mesh, dax)
    out = []
    for i, s in enumerate(tuple(spec_in) + (None,) * (len(shape) - len(spec_in))):
        if s is None:
            out.append(None)
            continue
        if s == "__data__":
            out.append(dax if shape[i] % dsz == 0 else None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        out.append(s if shape[i] % _axes_size(mesh, axes) == 0 else None)
    return spec(*out)


def undivided(mesh: Mesh, shape: tuple, spec_in: tuple) -> list:
    """The dimensions of ``shape`` that ``spec_in`` shards over axes whose
    size does not divide them (:func:`sanitize_spec` drops those to
    replicated): (dimension, its size, the axes' size) each."""
    mesh = _as_mesh(mesh)
    out = []
    for i, s in enumerate(spec_in):
        if s is None:
            continue
        axes = _data_axes(mesh) if s == "__data__" else s if isinstance(s, tuple) else (s,)
        size = _axes_size(mesh, axes)
        if shape[i] % size:
            out.append((i, shape[i], size))
    return out


# --- batch / cache rules ----------------------------------------------------

def batch_spec(mesh: Mesh, batch_size: int) -> tuple:
    """Token batches: shard batch over the (pod, data) axes when divisible."""
    mesh = _as_mesh(mesh)
    dax = _data_axes(mesh)
    if batch_size % _axes_size(mesh, dax) == 0:
        return spec(dax, None)
    return spec(None, None)


def batch_specs(mesh: Mesh, batch) -> dict:
    """Specs for a batch dict: the leading dim is batch for every leaf."""
    def one(_, leaf):
        nd = leaf.ndim
        if nd == 0:
            return ()
        lead = batch_spec(mesh, leaf.shape[0])
        return spec(*(lead[:1] + (None,) * (nd - 1)))

    return _map_with_path(one, batch)


def cache_spec(mesh: Mesh, leaf_shape: tuple, n_kv_heads: int) -> tuple:
    """KV/SSM cache leaves, stacked (L, B, ...).

    (L, B, S, Hk, Dh) attention cache; (L, B, W, C) conv; (L, B, H, P, N)
    SSM state.  Batch -> data axes when divisible, else sequence-parallel on
    axis 2.  Then one inner axis on 'model': heads, else the sequence axis
    (the split-KV decode scheme), else head_dim.
    """
    mesh = _as_mesh(mesh)
    dax = _data_axes(mesh)
    dsz = _axes_size(mesh, dax)
    msz = mesh.shape["model"]
    nd = len(leaf_shape)
    out = [None] * nd
    b = leaf_shape[1]
    if b % dsz == 0:
        out[1] = dax
    elif nd >= 3 and leaf_shape[2] % dsz == 0:
        out[2] = dax            # sequence parallelism (long-context decode)
    for ax in ((3, 2, 4) if nd == 5 else (3, 2) if nd == 4 else ()):
        if ax < nd and out[ax] is None and leaf_shape[ax] % msz == 0:
            out[ax] = "model"
            break
    return spec(*out)


def cache_specs(mesh: Mesh, cache, n_kv_heads: int) -> dict:
    return _map_with_path(lambda _, leaf: cache_spec(mesh, tuple(leaf.shape), n_kv_heads),
                          cache)


def shard_bytes(mesh: Mesh, leaf, leaf_spec: tuple) -> int:
    """Bytes of one device's shard of ``leaf`` under a sanitized spec (every
    sharded dimension divides its axes)."""
    mesh = _as_mesh(mesh)
    parts = 1
    for s in leaf_spec:
        if s is not None:
            parts *= _axes_size(mesh, s if isinstance(s, tuple) else (s,))
    return leaf.numel() * leaf.element_size() // parts


# --- placement on a DeviceMesh ----------------------------------------------

class NamedSharding(NamedTuple):
    """A ``DeviceMesh`` and one DTensor placement per mesh axis: where a
    tensor lives (the reference's ``jax.sharding.NamedSharding``)."""

    device_mesh: object
    placements: tuple


def placements(mesh, leaf_spec: tuple, ndim: int) -> tuple:
    """DTensor placements of a spec: ``Shard(dim)`` on each mesh axis that
    names dimension ``dim``, ``Replicate()`` on the others.  An entry such as
    ``("pod", "data")`` shards one dimension over both axes, major to minor,
    as ``PartitionSpec`` does; DTensor splits a dimension sharded on several
    mesh axes in mesh-axis order, so the entry's axes must come in that
    order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(_as_mesh(mesh).axis_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(tuple(leaf_spec) + (None,) * (ndim - len(leaf_spec))):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits dimension {dim} against the mesh "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _map_specs(fn, specs, tree=None):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, None if tree is None else tree[k])
                for k, v in specs.items()}
    return fn(specs, tree)


def to_named(device_mesh, specs, tree=None):
    """The tree of :class:`NamedSharding` for a tree of specs.  A spec
    shorter than its tensor's rank is padded with None; pass ``tree`` (the
    tensors) where the specs are not written out to full rank."""
    def one(s, leaf):
        nd = len(s) if leaf is None else leaf.ndim
        return NamedSharding(device_mesh, placements(device_mesh, s, nd))

    return _map_specs(one, specs, tree)


def local_shard(t, device_mesh, placements_: tuple):
    """This rank's shard of the full tensor ``t`` under ``placements_`` as a
    view of ``t`` (no copy): each sharded dimension narrowed to this rank's
    block, mesh axes in order, as DTensor splits a dimension sharded on
    several axes.  Every sharded dimension divides its axes (specs are
    sanitized)."""
    coord = device_mesh.get_coordinate()
    for i, pl in enumerate(placements_):
        if pl.is_shard():
            size = t.shape[pl.dim] // device_mesh.shape[i]
            t = t.narrow(pl.dim, coord[i] * size, size)
    return t


def place(tree, device_mesh, specs):
    """``tree``'s tensors as DTensors on ``device_mesh`` by ``specs``.

    Every rank holds the same full tensors (built from the same seed, or
    read from the same checkpoint) and keeps its own slice: no data moves.
    The slice is a copy where it is a part of the tensor (so the caller
    can drop the whole), the tensor itself where it is all of it (every
    sharding axis has one rank: no second copy).  A leaf that is already
    a DTensor is redistributed instead."""
    from torch.distributed.tensor import DTensor

    def one(s, leaf):
        pl = placements(device_mesh, s, leaf.ndim)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(device_mesh, pl)
        local = local_shard(leaf, device_mesh, pl)
        if local.numel() < leaf.numel():
            local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, device_mesh, pl, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())

    return _map_specs(one, specs, tree)
