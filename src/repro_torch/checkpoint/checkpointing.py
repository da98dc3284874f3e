"""Checkpoints in the reference's format (port of
``repro/checkpoint/checkpointing.py``).

One directory per step, ``step_<N>/``:

* ``manifest.json`` -- the step and each leaf's shape and dtype name;
* ``arrays.npz`` -- every leaf as a numpy array, under its flat key: the
  path of dict keys and NamedTuple fields joined by ``/`` (``#i`` for a
  list or tuple index; ``None`` leaves are skipped).

A checkpoint written by either package restores in the other.  A bfloat16
leaf (the AdamW moments with ``moment_dtype="bfloat16"``) is stored as the
reference stores it: its raw 2-byte words as a numpy void array (``V2``),
with ``bfloat16`` in the manifest.  This module reads such a leaf back bit
for bit from the manifest's dtype name, without ``ml_dtypes``.  (The
reference cannot restore a bfloat16 leaf at all, its own or this
module's: numpy has no cast from ``V2``.)

Writes are atomic (a ``.tmp_step_<N>`` directory renamed into place) and
optionally asynchronous: the leaves are copied to host memory before the
writer thread starts, so later in-place updates of the state do not reach
the file; ``wait()`` joins.  ``keep`` bounds the completed checkpoints
kept.

A state sharded over a device mesh (DTensor leaves) is saved by every rank
calling :func:`save`: each leaf is gathered whole (``full_tensor``) and
rank 0 writes it, in the same format.  ``restore(..., shardings=)`` places
each leaf on a mesh by its ``train.sharding.NamedSharding``, which may
belong to a mesh of another size than the one that saved it (the elastic
restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_SEP = "/"
_BF16 = "bfloat16"


def _flatten(tree, leaf=lambda node: False) -> dict[str, Any]:
    flat = {}

    def visit(path, node):
        if leaf(node):
            flat[_SEP.join(path)] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                visit(path + [str(k)], v)
        elif isinstance(node, (tuple, list)) and not hasattr(node, "_fields"):
            for i, v in enumerate(node):
                visit(path + [f"#{i}"], v)
        elif hasattr(node, "_fields"):  # NamedTuple
            for k in node._fields:
                v = getattr(node, k)
                if v is not None:
                    visit(path + [k], v)
        elif node is not None:
            flat[_SEP.join(path)] = node

    visit([], tree)
    return flat


def _writer() -> bool:
    """Whether this process writes checkpoint files (rank 0, or no
    process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a numpy copy of ``t``, its dtype name); bfloat16 as raw ``V2``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, keep: int = 3, async_save: bool = False):
    """Checkpoint ``tree`` at ``step``.  Returns a handle with ``.wait()``.
    Under a process group every rank calls it and rank 0 writes: each
    DTensor leaf is gathered whole on every rank (a collective), and only
    the writer copies it to host memory."""
    host, dtypes = {}, {}
    writer = _writer()
    for k, v in _flatten(tree).items():
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        if writer:
            host[k], dtypes[k] = _to_host(v)
        del v
    if not writer:
        return _Handle(None)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in host.items()},
    }

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return _Handle(t)
    _write()
    return _Handle(None)


class _Handle:
    def __init__(self, thread):
        self._t = thread

    def wait(self):
        if self._t is not None:
            self._t.join()


def _gc(ckpt_dir: str, keep: int):
    for s in all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    """The steps of the completed (renamed) checkpoints, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_")
                  and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_tensor(arr: np.ndarray, dtype_name: str, key: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")       # keeps 0-d leaves 0-d
    if arr.dtype.kind == "V":
        if dtype_name != _BF16 or arr.dtype.itemsize != 2:
            raise ValueError(f"{key}: raw {arr.dtype} leaf with manifest dtype "
                             f"{dtype_name!r}; only bfloat16 is stored raw")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, target_tree, device=None, shardings=None):
    """Restore into the structure of ``target_tree``: each leaf is cast to
    its target leaf's dtype and placed on ``device`` (by default the target
    leaf's device).  Raises on a missing leaf or a shape mismatch.

    ``shardings``: a tree of ``train.sharding.NamedSharding`` of the same
    structure; each leaf it covers becomes a DTensor on that mesh, every
    rank keeping its own shards of the file's full leaf (the elastic
    restore: the mesh need not be the one that saved)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        host = {k: z[k] for k in z.files}

    flat_target = _flatten(target_tree)
    flat_shard = _flatten(shardings, leaf=_is_sharding) if shardings is not None else {}
    missing = set(flat_target) - set(host)
    if missing:
        raise ValueError(f"checkpoint at {path} missing leaves: {sorted(missing)[:5]}...")

    restored = {}
    for k, tgt in flat_target.items():
        arr = host[k]
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {k}: ckpt {arr.shape} vs target "
                             f"{tuple(tgt.shape)}")
        t = _to_tensor(arr, leaves[k]["dtype"], k)
        if k in flat_shard:
            restored[k] = _place(t.to(tgt.dtype), flat_shard[k])
        else:
            restored[k] = t.to(device=tgt.device if device is None else device,
                               dtype=tgt.dtype)
    return _unflatten_like(target_tree, restored)


def _is_sharding(node) -> bool:
    return hasattr(node, "device_mesh") and hasattr(node, "placements")


def _place(t: torch.Tensor, named) -> torch.Tensor:
    """``t`` as a DTensor on ``named.device_mesh``, this rank's shards."""
    from torch.distributed.tensor import distribute_tensor

    mesh = named.device_mesh
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return distribute_tensor(t.to(dev), mesh, named.placements, src_data_rank=None)


def _unflatten_like(tree, flat: dict, path=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, path + (str(k),)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        vals = {}
        for k in tree._fields:
            v = getattr(tree, k)
            vals[k] = None if v is None else _unflatten_like(v, flat, path + (k,))
        return type(tree)(**vals)
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            _unflatten_like(v, flat, path + (f"#{i}",)) for i, v in enumerate(tree)
        )
    if tree is None:
        return None
    return flat[_SEP.join(path)]
