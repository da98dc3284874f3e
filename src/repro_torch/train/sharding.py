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

Placing tensors by these specs (``to_named``) comes with the multi-device
slice.
"""
from __future__ import annotations

from repro_torch.launch.mesh import Mesh


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
    is_expert = (parent in ("w_gate", "w_up", "w_down") and ndim >= 3
                 and "moe" in names and "shared" not in names)
    if is_expert:
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
    def one(path, leaf):
        s = param_spec(path, leaf, fsdp=fsdp)
        return s if mesh is None else sanitize_spec(mesh, tuple(leaf.shape), s)

    return _map_with_path(one, params)


def sanitize_spec(mesh: Mesh, shape: tuple, spec_in: tuple) -> tuple:
    """Drop shardings that don't divide; resolve the '__data__' placeholder."""
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


# --- batch / cache rules ----------------------------------------------------

def batch_spec(mesh: Mesh, batch_size: int) -> tuple:
    """Token batches: shard batch over the (pod, data) axes when divisible."""
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
    parts = 1
    for s in leaf_spec:
        if s is not None:
            parts *= _axes_size(mesh, s if isinstance(s, tuple) else (s,))
    return leaf.numel() * leaf.element_size() // parts
