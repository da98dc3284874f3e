"""Dry-run on the meta device: build and run every (arch x shape x mesh) cell
with shapes only (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 512 placeholder host
devices and reads one device's share from the partitioned program.  Here the
cell's step runs once on the ``meta`` device, at full width: every tensor
carries its shape and dtype and no data, so nothing is allocated, no GPU is
needed and no environment flag is set.  On a 1 x 1 mesh the step is the
plain one.  On a larger mesh this process is rank 0 of a fake
``torch.distributed`` world of ``mesh.size`` ranks
(``launch.mesh.fake_world``), and the step is the one that runs across real
ranks: the serve cells of :func:`mesh_cells` on DTensors, the train cell
``train.jit_train_step`` (params gathered at use, gradients
reduce-scattered), each on rank 0's shards.  Per cell this module

  1. builds the cell's step and its meta inputs, with the sharding rules of
     ``repro_torch.train.sharding`` giving each argument's per-device shard
     (:func:`lower_cell`),
  2. runs the step once under a dispatch mode (:class:`MetaTrace`) that
     counts the FLOPs of the local ops with ``torch.utils.flop_counter``'s
     formulas, follows the live meta bytes and adds up the bytes of each
     collective, while the kernel wrappers' meta branches record their
     calls in ``kernels.tally`` (:func:`measure`),
  3. derives the three roofline terms (``repro_torch.launch.roofline``),
  4. appends the record, in the reference's schema, to the output JSON
     (incremental, resumable).

Every count is per device.  ``memory_analysis`` holds arguments and outputs
by their sharding specs; ``temp_size_in_bytes`` is the step's peak of live
bytes beyond its arguments (outputs included, as the card's allocator
counts them).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun.json
  python -m repro_torch.launch.dryrun --all --weights dense --out build/dryrun_dense.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.configs as configs
from repro_torch.kernels import tally
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, fake_world, make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import OptConfig
from repro_torch.optim.optimizer import AdamWState
from repro_torch.serving.engine import freeze_params
from repro_torch.train import TrainState, init_state, jit_train_step, make_train_step
from repro_torch.train import sharding

BIG_PARAMS = 60e9  # above this, bf16 adam moments (fits 400B on one pod)


@dataclass
class Lowered:
    """A cell's step and its meta arguments.  ``arg_specs`` / ``out_specs``
    mirror the arguments / outputs (a None subtree is replicated)."""

    fn: Callable
    args: tuple
    arg_specs: tuple
    out_specs: tuple

    def run(self):
        return self.fn(*self.args)


def _pairs(tree, specs):
    """(tensor, spec or None) for every tensor leaf of ``tree``, walking the
    spec tree alongside."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, None if specs is None else specs[k])
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _pairs(v, None if specs is None else specs[i])


def tree_bytes(mesh: Mesh, tree, specs=None) -> int:
    """Bytes of one device's shards of ``tree``'s tensors under ``specs``
    (replicated where the spec is None)."""
    return sum(sharding.shard_bytes(mesh, t, s) if s is not None
               else t.numel() * t.element_size() for t, s in _pairs(tree, specs))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _storage_keys(tree) -> set:
    return {_local(t).untyped_storage()._cdata for t, _ in _pairs(tree, None)}


# The collectives the port's steps issue, by (namespace, op name): the
# functional collectives of DTensor (and its all-to-all) return their
# result; the c10d ops of raw ``dist.*`` calls write into their first
# argument.  The kinds are the reference's names
# (``roofline.collective_bytes_from_hlo``), the bytes its convention: the
# result per device (an all-reduce's tensor, an all-gather's gathered
# tensor, a reduce-scatter's shard, an all-to-all's output).
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_base_"): "all-to-all",
}
# Ops of those namespaces that move no data of their own: the second half of
# an async pair (counted once, at its start), the autograd wrapper, a
# process-group lookup.  Any other op there raises: its bytes would be missed.
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd", "mesh_get_process_group"}
_COMM_NAMESPACES = {"c10d", "_c10d_functional", "_c10d_functional_autograd", "_dtensor"}
# Ops that allocate and touch no memory: they access no bytes.
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _accesses_bytes(func) -> bool:
    """Whether ``func`` reads or writes tensor data: not a view (a result
    that only aliases an input, as ``view``, ``transpose`` or ``select``
    give) and not an allocation."""
    if func._overloadpacket.__name__ in _ALLOCATIONS:
        return False
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


class MetaTrace(TorchDispatchMode):
    """One pass over a meta step: its FLOPs, by the formulas of
    ``torch.utils.flop_counter`` (``flop_registry``, the table
    ``FlopCounterMode`` counts with), the bytes of the meta storages
    created under it and still alive (each storage counted once, at its
    first appearance: views and in-place results share it), and the bytes
    of each kind of collective (``collectives``).  ``peak`` is the maximum
    of the live bytes.  Storages in ``exclude`` (the step's arguments) are
    not counted.  ``bytes_accessed`` adds up, over the local ops that are
    not collectives, the bytes of each op's tensor inputs and outputs
    (every operand read once, every result written once); a view moves
    nothing, nor does an allocation.  One mode does all of it because each Python dispatch mode
    costs every op of the trace a Python call, and ``FlopCounterMode`` also
    tries to decompose every op its table does not list; the counts equal
    ``FlopCounterMode``'s (``tests/test_torch_launch.py``).

    Only the local ops of this rank count.  An op on DTensors is passed on
    to DTensor (``NotImplemented``), which runs the local ops and the
    collectives under it through this mode again.  DTensor's sharding
    propagation runs ops on fake tensors of the global shapes, under a
    fake tensor mode, on a cache miss only: those are not this rank's work
    and are not counted, so the counts do not depend on what ran before.
    A collective ``_COLLECTIVES`` does not know raises."""

    def __init__(self, exclude: set):
        super().__init__()
        from torch.distributed.tensor import DTensor

        self._dtensor = DTensor
        self.exclude = exclude
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.collectives: dict[str, int] = {}
        self._seen: set = set()

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._seen.discard(key)

    def _collective(self, func, args, out) -> None:
        name = func._schema.name.split("::")[1]
        if name in _NOT_COLLECTIVES:
            return
        kind = _COLLECTIVES.get((func.namespace, name))
        if kind is None:
            raise RuntimeError(f"the dry-run does not know the collective {func}")
        result = args[0] if func.namespace == "c10d" else out
        self.collectives[kind] = self.collectives.get(kind, 0) + _nbytes(result)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out          # DTensor's sharding propagation (see the docstring)
        if func.namespace in _COMM_NAMESPACES:
            self._collective(func, args, out)
        elif _accesses_bytes(func):
            self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(out)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in (out,) if isinstance(out, torch.Tensor) else pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.device.type != "meta":
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.exclude or key in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen.add(key)
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, nbytes)
        return out


def _dense_bf16(tree):
    """The fp16-kernel baseline: latent float32 matrices in bf16."""
    if isinstance(tree, dict):
        return {k: _dense_bf16(v) for k, v in tree.items()}
    if tree.dtype == torch.float32 and tree.ndim >= 2:
        return torch.empty(tree.shape, dtype=torch.bfloat16, device=tree.device)
    return tree


def serve_fsdp(cfg, mesh, weights: str = "packed") -> bool:
    """Whether a serve cell shards its weights over the data axes too: only
    when the tensor-parallel shards alone would pass 8 GB (packed 2-bit
    weights fit them outright; FSDP trades that residency for per-layer
    weight all-gathers every decode step)."""
    mesh = sharding._as_mesh(mesh)
    bytes_per_w = 0.25 if weights == "packed" else 2.0
    return cfg.n_params() * bytes_per_w / mesh.shape["model"] / 1e9 > 8.0


def lower_cell(cfg, shape, mesh: Mesh, *, weights: str = "packed", fsdp: bool = True,
               remat: bool = True, cache_dtype=torch.bfloat16,
               device_mesh=None) -> tuple[Lowered, dict]:
    """Build the cell's step and its meta arguments.  Returns (lowered, meta).

    With a ``device_mesh`` (a ``DeviceMesh`` of ``mesh``'s axes) the step
    is the one that runs on it and its arguments are placed there: the
    train state by ``jit_train_step``, the params and cache by
    :func:`mesh_cells`; the batch stays global, as every rank passes it."""
    kind = shape.kind
    if kind == "train":
        opt_cfg = OptConfig(
            moment_dtype="bfloat16" if cfg.n_params() > BIG_PARAMS else "float32")
        state = init_state(cfg, None, opt_cfg, device="meta")
        batch = zoo.input_specs(cfg, shape)
        meta = {"mode": "train_step",
                "uneven": uneven_dims(mesh, state.params, fsdp, batch, rows_over_model=True)}
        if device_mesh is not None:
            step = jit_train_step(cfg, opt_cfg, device_mesh, state, batch, fsdp=fsdp,
                                  remat=remat)
            specs = step.state_specs
            return (Lowered(step, (step.place(state), batch), (specs, step.batch_specs),
                            (specs, None)), meta)
        pspecs = sharding.param_specs(state.params, mesh, fsdp=fsdp)
        mspecs = sharding.param_specs(state.opt.mu, mesh, fsdp=fsdp)
        state_specs = TrainState(params=pspecs,
                                 opt=AdamWState(mu=mspecs, nu=mspecs, count=()),
                                 step=(), err_buf=None)
        bspecs = sharding.batch_specs(mesh, batch)
        step = make_train_step(cfg, opt_cfg, remat=remat)
        return (Lowered(step, (state, batch), (state_specs, bspecs), (state_specs, None)),
                meta)

    # Inference cells: params in the requested weight format.  Serve cells
    # take FSDP only when the tensor-parallel shards alone would not fit:
    # packed 2-bit weights fit them outright, and FSDP would trade that
    # residency for per-layer weight all-gathers every decode step.
    params = zoo.param_specs(cfg)
    if weights == "packed":
        params = freeze_params(params)
    elif weights == "dense":
        params = _dense_bf16(params)
    p_fsdp = serve_fsdp(cfg, mesh, weights)
    pspecs = sharding.param_specs(params, mesh, fsdp=p_fsdp)

    inputs = zoo.input_specs(cfg, shape, cache_dtype=cache_dtype)
    cache = inputs.pop("cache")
    cspecs = sharding.cache_specs(mesh, cache, cfg.n_kv_heads)
    uneven = uneven_dims(mesh, params, p_fsdp, {"tokens": inputs["tokens"]}, cache)
    # decode / serve_step: the step's length is the cache's last row, so
    # attention reads the whole cache as the reference's traced step does.
    t_last = shape.seq_len - 1
    if device_mesh is None:
        prefill = lambda p, b, c: zoo.prefill(cfg, p, b, c, train=False)  # noqa: E731
        decode = lambda p, tk, c, t: zoo.decode_step(cfg, p, tk, c, t_last,  # noqa: E731
                                                     train=False)
    else:
        cells = mesh_cells(cfg, params, device_mesh, fsdp=p_fsdp)
        params, cache = cells.params, cells.place_cache(cache)
        prefill = lambda p, b, c: cells.prefill(b, c)  # noqa: E731
        decode = lambda p, tk, c, t: cells.decode_step(tk, c, t_last)  # noqa: E731

    if kind == "prefill":
        bspecs = sharding.batch_specs(mesh, inputs)
        return (Lowered(prefill, (params, inputs, cache), (pspecs, bspecs, cspecs),
                        (None, cspecs)), {"mode": "prefill", "uneven": uneven})
    tspec = sharding.batch_specs(mesh, {"tokens": inputs["tokens"]})["tokens"]
    return (Lowered(decode, (params, inputs["tokens"], cache, inputs["t"]),
                    (pspecs, tspec, cspecs, ()), (None, cspecs)),
            {"mode": "serve_step", "uneven": uneven})


def uneven_dims(mesh: Mesh, params, fsdp: bool, batch: dict, cache=None,
                rows_over_model: bool = False) -> list:
    """Where a cell's dims do not divide its mesh axes, so that ranks may
    hold unequal shares: each param leaf's dimension that its rule
    (``sharding.param_spec``) shards over axes that do not divide it, the
    batch's rows over the data axes (for a train cell also a data slice's
    rows over 'model', as ``train.sharded_loss_and_grads`` splits them),
    and each cache leaf's batch over the data axes.  Returns them as
    ``"path: n over k"`` strings; empty where everything divides."""
    mesh = sharding._as_mesh(mesh)
    dsz = sharding._axes_size(mesh, sharding._data_axes(mesh))
    msz = mesh.shape["model"]
    out = []

    def walk(tree, path, rule):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (str(k),), rule)
        elif isinstance(tree, torch.Tensor):
            for i, n, k in sharding.undivided(mesh, tuple(tree.shape), rule(path, tree)):
                out.append(f"{'/'.join(path)}[{i}]: {n} over {k}")

    walk(params, (), lambda path, leaf: sharding.param_spec(path, leaf, fsdp=fsdp))
    rows = batch["tokens"].shape[0]
    if rows % dsz:
        out.append(f"batch: {rows} rows over {dsz}")
    elif rows_over_model and (rows // dsz) % msz:
        out.append(f"batch: {rows // dsz} rows of a data slice over {msz}")
    if cache is not None:
        walk(cache, ("cache",), lambda path, leaf: (None, "__data__"))
    return out


class MeshCells(NamedTuple):
    """The serve cells of :func:`mesh_cells` (see there)."""

    place_cache: Callable
    prefill: Callable
    decode_step: Callable
    params: dict


def mesh_cells(cfg, params: dict, device_mesh, *, fsdp: bool | None = None) -> MeshCells:
    """The prefill and decode cells run on a ``torch.distributed``
    ``DeviceMesh``: the counterparts of the reference's jitted
    ``lower_cell`` steps, with the same specs as :func:`lower_cell`.

    The (frozen or latent) ``params`` are placed by
    ``sharding.param_specs(fsdp=)`` (by default :func:`serve_fsdp`'s rule)
    and a cache by ``sharding.cache_specs`` (``place_cache``).  Each step
    places its token batch by ``sharding.batch_specs``, registers the mesh
    for the activation constraints (``utils.act_sharding``) and runs
    ``model_zoo.prefill`` / ``decode_step`` on the DTensors: the packed
    projections run ``tsar_matmul`` on each rank's local shards
    (``models.layers``), the MoE experts their expert-parallel branch, and
    the tensors the step creates are replicated on the mesh
    (``implicit_replication``).  ``prefill(batch, cache)`` and
    ``decode_step(tokens, cache, t)`` return (the full logits as a plain
    tensor on every rank, the cache placed as it came); ``params`` is the
    placed tree.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.utils import act_sharding

    if fsdp is None:
        fsdp = serve_fsdp(cfg, device_mesh, "packed" if _packed(params) else "latent")
    placed = sharding.place(params, device_mesh,
                            sharding.param_specs(params, device_mesh, fsdp=fsdp))

    def cache_specs(cache):
        return sharding.cache_specs(device_mesh, cache, cfg.n_kv_heads)

    def place_cache(cache):
        return sharding.place(cache, device_mesh, cache_specs(cache))

    def run(fn, cache, *args):
        specs = cache_specs(cache)
        before = act_sharding.get_mesh()
        act_sharding.set_mesh(device_mesh)
        try:
            with implicit_replication(), torch.no_grad():
                logits, new = fn(cfg, placed, *args, sharding.place(cache, device_mesh, specs))
        finally:
            act_sharding.set_mesh(before)
        return logits.full_tensor(), sharding.place(new, device_mesh, specs)

    def prefill(batch, cache):
        b = sharding.place(batch, device_mesh, sharding.batch_specs(device_mesh, batch))
        return run(lambda c, p, bt, ca: zoo.prefill(c, p, bt, ca, train=False), cache, b)

    def decode_step(tokens, cache, t):
        tk = sharding.place({"tokens": tokens}, device_mesh,
                            sharding.batch_specs(device_mesh, {"tokens": tokens}))["tokens"]
        return run(lambda c, p, x, ca: zoo.decode_step(c, p, x, ca, t, train=False),
                   cache, tk)

    return MeshCells(place_cache, prefill, decode_step, placed)


def _packed(params) -> bool:
    if isinstance(params, dict):
        return "sign" in params or any(_packed(v) for v in params.values())
    return False


def measure(lowered: Lowered, mesh: Mesh) -> dict:
    """Run the step once on meta: FLOPs, kernel tally, live bytes, bytes
    accessed (the local ops' and the kernel calls'), collectives, all per
    device.  Returns the counts, the per-device ``memory_analysis``, the
    kernel calls and the collective bytes by kind."""
    trace = MetaTrace(_storage_keys(lowered.args))
    del tally.TALLY[:]
    try:
        with trace:
            out = lowered.run()
        kernels, kernel_ops, n_calls = tally.counts(), tally.ops(), len(tally.TALLY)
        kernel_bytes = tally.nbytes()
    finally:
        del tally.TALLY[:]
    counts = {"flops": float(trace.flops), "kernel_ops": float(kernel_ops),
              "kernel_calls": float(n_calls),
              "bytes accessed": float(trace.bytes_accessed + kernel_bytes)}
    mem = {"argument_size_in_bytes": float(tree_bytes(mesh, lowered.args, lowered.arg_specs)),
           "output_size_in_bytes": float(tree_bytes(mesh, out, lowered.out_specs)),
           "temp_size_in_bytes": float(trace.peak)}
    return {"counts": counts, "memory_analysis": mem, "kernels": kernels,
            "collectives": {k: float(v) for k, v in trace.collectives.items()}}


def _trace_rank(cfg, shape, mesh: Mesh, rank: int, weights: str, kw: dict) -> tuple:
    """(lower_cell's meta, measure's counts) of the cell as ``rank`` of a
    fake world of ``mesh.size`` ranks (a 1 x 1 mesh: the plain step)."""
    world = fake_world(mesh, rank=rank) if mesh.size > 1 else contextlib.nullcontext()
    with world as device_mesh:
        lowered, meta = lower_cell(cfg, shape, mesh, weights=weights,
                                   device_mesh=device_mesh, **kw)
        m = measure(lowered, mesh)
        del lowered
    return meta, m


def _larger(a: dict, b: dict) -> dict:
    """Per term, the larger of two ranks' :func:`measure` counts."""
    return {part: {k: max(a[part].get(k, 0), b[part].get(k, 0))
                   for k in {**a[part], **b[part]}} for part in a}


def run_cell(cfg, shape, mesh: Mesh, mesh_name: str, weights: str = "packed",
             verbose: bool = True, **kw) -> dict:
    """One cell's record.  A mesh of more than one device is traced as
    rank 0 of a fake world of ``mesh.size`` ranks (``mesh.fake_world``,
    destroyed before this returns; a process group already initialized
    here is an error, never replaced).  Where a dim of the cell's params,
    batch or cache does not divide its axes (:func:`uneven_dims`, listed
    under ``uneven``), the last rank is traced too: each term of the record
    is the larger of the two ranks', and ``ranks`` holds both ranks' own
    counts.  Any failure is the record's ``status: "error"`` with its
    reason."""
    chips = mesh.size
    rec: dict[str, Any] = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                           "chips": int(chips), "weights": weights, "status": "ok"}
    t0 = time.time()
    try:
        meta, m = _trace_rank(cfg, shape, mesh, 0, weights, kw)
        uneven = meta.pop("uneven")
        rec.update(meta)
        if chips > 1 and uneven:
            last = _trace_rank(cfg, shape, mesh, chips - 1, weights, kw)[1]
            rec["uneven"] = uneven
            rec["ranks"] = {"0": m, str(chips - 1): last}
            m = _larger(m, last)
        mf = rl.model_flops_for_cell(cfg, shape)
        roof = rl.analyze(cfg.name, shape.name, mesh_name, int(chips), m["counts"], mf,
                          memory_stats=m["memory_analysis"], collectives=m["collectives"])
        rec["roofline"] = roof.to_json()
        rec["cost"] = m["counts"]
        rec["kernels"] = m["kernels"]
        rec["memory_analysis"] = m["memory_analysis"]
        if verbose:
            print(f"  memory_analysis: {rec['memory_analysis']}")
            r = rec["roofline"]
            print(f"  flops/dev={r['flops_per_device']:.3e} "
                  f"bytes/dev={r['bytes_per_device']:.3e} "
                  f"coll/dev={r['collective_bytes_per_device']:.3e} -> "
                  f"bound={r['bound']}")
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  FAILED: {rec['error']}")
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


MESHES = {"single": lambda: make_production_mesh(multi_pod=False),
          "multi": lambda: make_production_mesh(multi_pod=True)}


def _run_job(job: tuple, verbose: bool = False) -> dict:
    arch, shape_name, mesh_name, weights, kw = job
    return run_cell(configs.get(arch), configs.SHAPES[shape_name], MESHES[mesh_name](),
                    mesh_name, weights=weights, verbose=verbose, **kw)


def sweep(jobs: list, workers: int = 1, verbose: bool = False):
    """``run_cell`` over ``jobs`` of (arch, shape name, mesh name, weights,
    kwargs), yielding records in order; ``workers > 1`` runs them in that
    many spawned processes of one torch thread each (meta cells are
    CPU-bound and independent)."""
    if workers <= 1:
        for job in jobs:
            if verbose:
                print(f"[dryrun] {job[0]} x {job[1]} x {job[2]} ({job[3]})", flush=True)
            yield _run_job(job, verbose)
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=workers, initializer=torch.set_num_threads,
                             initargs=(1,),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        yield from ex.map(_run_job, jobs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--weights", choices=["packed", "dense", "latent"], default="packed")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--cache-dtype", default="bfloat16")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already present in --out")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(cfg, shape) for cfg, shape, _ in configs.cells()]
    else:
        cfg = configs.get(args.arch)
        shapes = [configs.SHAPES[args.shape]] if args.shape else [
            s for c, s, skip in configs.cells() if c.name == cfg.name and not skip]
        cells = [(cfg, s) for s in shapes]
    mesh_names = {"single": ["single"], "multi": ["multi"],
                  "both": ["single", "multi"]}[args.mesh]

    done = set()
    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        if args.skip_done:
            done = {(r["arch"], r["shape"], r["mesh"], r.get("weights", "packed"))
                    for r in results if r.get("status") == "ok"}

    kw = {"fsdp": not args.no_fsdp, "remat": not args.no_remat,
          "cache_dtype": getattr(torch, args.cache_dtype)}
    jobs = [(cfg.name, shape.name, mesh_name, args.weights, kw)
            for cfg, shape in cells for mesh_name in mesh_names
            if (cfg.name, shape.name, mesh_name, args.weights) not in done]
    for rec in sweep(jobs, verbose=True):
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"  -> {rec['status']} ({rec['wall_s']}s)"
              + (f" {rec['error']}" if rec["status"] != "ok" else ""), flush=True)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    print(f"\n{n_ok}/{len(results)} cells OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
