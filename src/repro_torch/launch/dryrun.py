"""Dry-run on the meta device: build and run every (arch x shape x mesh) cell
with shapes only (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 512 placeholder host
devices.  Here the cell's step runs once on the ``meta`` device, at full
width: every tensor carries its shape and dtype and no data, so nothing is
allocated, no GPU is needed and no environment flag is set.  Per cell this
module

  1. builds the cell's step (``make_train_step`` for train cells,
     ``model_zoo.prefill`` for prefill, ``model_zoo.decode_step`` for
     decode) and its meta inputs, with the sharding rules of
     ``repro_torch.train.sharding`` giving each argument's per-device shard,
  2. runs the step once under a dispatch mode (:class:`MetaTrace`) that
     counts its FLOPs with ``torch.utils.flop_counter``'s formulas and
     follows the live meta bytes, while the kernel wrappers' meta branches
     record their calls in ``kernels.tally``,
  3. derives the three roofline terms (``repro_torch.launch.roofline``),
  4. appends the record, in the reference's schema, to the output JSON
     (incremental, resumable).

``memory_analysis`` holds per-device bytes: arguments and outputs by their
sharding specs; ``temp_size_in_bytes`` is the step's peak of live bytes
beyond its arguments (outputs included, as the card's allocator counts
them), divided by the chips under a mesh larger than 1 x 1 (an ideal split:
the trace is the unsharded step).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun.json
  python -m repro_torch.launch.dryrun --all --weights dense --out build/dryrun_dense.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

import repro_torch.configs as configs
from repro_torch.kernels import tally
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import OptConfig
from repro_torch.optim.optimizer import AdamWState
from repro_torch.serving.engine import freeze_params
from repro_torch.train import TrainState, init_state, make_train_step, sharding

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


def _storage_keys(tree) -> set:
    return {t.untyped_storage()._cdata for t, _ in _pairs(tree, None)}


class MetaTrace(TorchDispatchMode):
    """One pass over a meta step: its FLOPs, by the formulas of
    ``torch.utils.flop_counter`` (``flop_registry``, the table
    ``FlopCounterMode`` counts with), and the bytes of the meta storages
    created under it and still alive (each storage counted once, at its
    first appearance: views and in-place results share it); ``peak`` is
    their maximum.  Storages in ``exclude`` (the step's arguments) are not
    counted.  One mode does both because each Python dispatch mode costs
    every op of the trace a Python call, and ``FlopCounterMode`` also tries
    to decompose every op its table does not list; the counts equal
    ``FlopCounterMode``'s (``tests/test_torch_launch.py``)."""

    def __init__(self, exclude: set):
        super().__init__()
        self.exclude = exclude
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def _free(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._seen.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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


def lower_cell(cfg, shape, mesh: Mesh, *, weights: str = "packed", fsdp: bool = True,
               remat: bool = True, cache_dtype=torch.bfloat16) -> tuple[Lowered, dict]:
    """Build the cell's step and its meta arguments.  Returns (lowered, meta)."""
    kind = shape.kind
    if kind == "train":
        opt_cfg = OptConfig(
            moment_dtype="bfloat16" if cfg.n_params() > BIG_PARAMS else "float32")
        state = init_state(cfg, None, opt_cfg, device="meta")
        pspecs = sharding.param_specs(state.params, mesh, fsdp=fsdp)
        mspecs = sharding.param_specs(state.opt.mu, mesh, fsdp=fsdp)
        state_specs = TrainState(params=pspecs,
                                 opt=AdamWState(mu=mspecs, nu=mspecs, count=()),
                                 step=(), err_buf=None)
        batch = zoo.input_specs(cfg, shape)
        bspecs = sharding.batch_specs(mesh, batch)
        step = make_train_step(cfg, opt_cfg, remat=remat)
        return (Lowered(step, (state, batch), (state_specs, bspecs), (state_specs, None)),
                {"mode": "train_step"})

    # Inference cells: params in the requested weight format.  Serve cells
    # take FSDP only when the tensor-parallel shards alone would not fit:
    # packed 2-bit weights fit them outright, and FSDP would trade that
    # residency for per-layer weight all-gathers every decode step.
    params = zoo.param_specs(cfg)
    if weights == "packed":
        params = freeze_params(params)
    elif weights == "dense":
        params = _dense_bf16(params)
    bytes_per_w = 0.25 if weights == "packed" else 2.0
    shard_gb = cfg.n_params() * bytes_per_w / mesh.shape["model"] / 1e9
    serve_fsdp = shard_gb > 8.0
    pspecs = sharding.param_specs(params, mesh, fsdp=serve_fsdp)

    inputs = zoo.input_specs(cfg, shape, cache_dtype=cache_dtype)
    cache = inputs.pop("cache")
    cspecs = sharding.cache_specs(mesh, cache, cfg.n_kv_heads)

    if kind == "prefill":
        bspecs = sharding.batch_specs(mesh, inputs)
        return (Lowered(lambda p, b, c: zoo.prefill(cfg, p, b, c, train=False),
                        (params, inputs, cache), (pspecs, bspecs, cspecs), (None, cspecs)),
                {"mode": "prefill"})

    # decode / serve_step: the step's length is the cache's last row, so
    # attention reads the whole cache as the reference's traced step does.
    tspec = sharding.batch_specs(mesh, {"tokens": inputs["tokens"]})["tokens"]
    t_last = shape.seq_len - 1
    return (Lowered(lambda p, tk, c, t: zoo.decode_step(cfg, p, tk, c, t_last, train=False),
                    (params, inputs["tokens"], cache, inputs["t"]),
                    (pspecs, tspec, cspecs, ()), (None, cspecs)),
            {"mode": "serve_step"})


def measure(lowered: Lowered, mesh: Mesh) -> dict:
    """Run the step once on meta: FLOPs, kernel tally, live bytes.
    Returns the counts and the per-device ``memory_analysis``."""
    chips = mesh.size
    trace = MetaTrace(_storage_keys(lowered.args))
    del tally.TALLY[:]
    with trace:
        out = lowered.run()
    kernels, kernel_ops, n_calls = tally.counts(), tally.ops(), len(tally.TALLY)
    del tally.TALLY[:]
    counts = {"flops": float(trace.flops), "kernel_ops": float(kernel_ops),
              "kernel_calls": float(n_calls)}
    mem = {"argument_size_in_bytes": float(tree_bytes(mesh, lowered.args, lowered.arg_specs)),
           "output_size_in_bytes": float(tree_bytes(mesh, out, lowered.out_specs)),
           "temp_size_in_bytes": float(trace.peak // chips)}
    return {"counts": counts, "memory_analysis": mem, "kernels": kernels}


def run_cell(cfg, shape, mesh: Mesh, mesh_name: str, weights: str = "packed",
             verbose: bool = True, **kw) -> dict:
    chips = mesh.size
    rec: dict[str, Any] = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                           "chips": int(chips), "weights": weights, "status": "ok"}
    t0 = time.time()
    try:
        lowered, meta = lower_cell(cfg, shape, mesh, weights=weights, **kw)
        rec.update(meta)
        m = measure(lowered, mesh)
        del lowered
        mf = rl.model_flops_for_cell(cfg, shape)
        roof = rl.analyze(cfg.name, shape.name, mesh_name, int(chips), m["counts"], mf,
                          memory_stats=m["memory_analysis"])
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
