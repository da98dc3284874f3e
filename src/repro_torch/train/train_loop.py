"""Training step construction: gradient accumulation, activation
recomputation, the step sharded over a device mesh and the compressed
data-parallel variant (port of ``repro/train/train_loop.py``).

``TrainState`` is a NamedTuple with the reference's fields (params, opt
state, step, error-feedback buffer), so checkpoints of either package
carry the same keys.  A step runs eagerly on the params' device and
updates the state's tensors in place (``optim.adamw_update``); it returns
the state and float32 scalar metrics.

:func:`jit_train_step` keeps the state as DTensors placed by the sharding
rules and runs the model as FSDP does (``train.fsdp``): every rank runs
forward and backward on its own rows of the global batch with plain
tensors, each param is all-gathered at use (a layer's inside the layer),
each gradient is reduce-scattered into the rank's shard of its mean over
the ranks, and AdamW updates each rank's shards.  A rank holds its shards,
the params outside the layer stack whole, and one layer's whole params
at a time; what each layer keeps for the backward (its ternarized weights
among it, unless ``remat``) adds to that as in one process.  The model's
ops are not run on DTensors here: DTensor's op-by-op sharding propagation cost about 38 s
of host time on the first call of the two-layer reduced bitnet on a
(2, 2) CPU mesh, and its K-sharded partial sums moved the loss 2.3e-4 from
the one-process step (int8 activation codes follow the summation order).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.optim import OptConfig, adamw_init, adamw_update, compression
from repro_torch.optim.optimizer import AdamWState
from repro_torch.train import sharding
from repro_torch.train.fsdp import Split
from repro_torch.train.fsdp import global_norm as sharded_global_norm
from repro_torch.utils.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor
    err_buf: Any = None      # int8-compression error feedback (optional)


def init_state(cfg, generator: torch.Generator, opt_cfg: OptConfig,
               compressed: bool = False, device="cuda") -> TrainState:
    """Fresh latent params from ``generator`` (which must live on
    ``device``; None on ``meta``), zero moments in
    ``opt_cfg.moment_dtype``, step 0."""
    dev = resolve_device(device)
    params = model_zoo.init_params(cfg, generator, dev)
    return TrainState(
        params=params,
        opt=adamw_init(params, getattr(torch, opt_cfg.moment_dtype)),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        err_buf=compression.init_error_buffer(params) if compressed else None,
    )


def loss_and_grads(cfg, params, batch: dict, *, remat: bool = False,
                   accum_steps: int = 1, split=None) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of ``model_zoo.loss_fn`` (``train=True``).
    With a ``split`` (``train.fsdp.Split``) ``params`` are this rank's
    shards and ``batch`` its rows, and the gradients are the shards of
    their mean over the ranks.

    With ``accum_steps > 1`` the batch's leading dim is split into that
    many microbatches run one after another; each one's gradient is added
    in place into the same buffers and the sum is divided by
    ``accum_steps``, the loss and metrics are the microbatches' means (the
    reference's scan).  Only one microbatch's activations are alive at a
    time.
    """
    # Autograd leaves sharing the params' storage: the gradients accumulate
    # in their ``.grad`` and the state's tensors stay as they are.
    aliases = tree_map(lambda p: p.detach().requires_grad_(True), params)
    micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps) + tuple(v.shape[1:]))[i]
              for k, v in batch.items()} for i in range(accum_steps)]
    losses, metrics = [], []
    for mb in micro:
        loss, m = model_zoo.loss_fn(cfg, aliases, mb, train=True, remat=remat, split=split)
        loss.backward()
        losses.append(loss.detach())
        metrics.append({k: v.detach() for k, v in m.items()})
    # A leaf the loss does not reach gets zeros, as ``jax.grad`` gives.
    grads = tree_map(lambda a, p: torch.zeros_like(p) if a.grad is None else a.grad,
                     aliases, params)
    if accum_steps > 1:
        for g in leaves(grads):
            g.div_(accum_steps)
    mean = {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}
    return torch.stack(losses).mean(), mean, grads


def make_train_step(cfg, opt_cfg: OptConfig, *, remat: bool = False, accum_steps: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: gradients
    (:func:`loss_and_grads`) then AdamW.  The state's params and moments
    are updated in place; its step is advanced."""

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = loss_and_grads(cfg, state.params, batch, remat=remat,
                                              accum_steps=accum_steps)
        params, opt, opt_metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        del grads
        return (TrainState(params, opt, state.step + 1, state.err_buf),
                dict(metrics, **opt_metrics, loss=loss))

    return train_step


def _rows(batch: dict, index: int, count: int) -> dict:
    """Rows ``[index * B/count, (index + 1) * B/count)`` of every leaf."""
    b = next(iter(batch.values())).shape[0]
    if b % count:
        raise ValueError(f"a batch of {b} rows does not split over {count} processes")
    n = b // count
    return {k: v[index * n:(index + 1) * n] for k, v in batch.items()}


def _pmean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The float32 mean of ``t`` over the processes of ``group``."""
    t = t.detach().to(torch.float32).clone()
    dist.all_reduce(t, group=group)
    return t / dist.get_world_size(group)


def make_compressed_dp_train_step(cfg, opt_cfg: OptConfig, *, remat: bool = False,
                                  group=None):
    """Data-parallel step with the int8 error-feedback gradient mean
    (``optim.compression.psum_compressed``) over the processes of
    ``group``: the params are replicated, each process takes its rows of
    the global batch (the reference's ``P('data')`` batch spec), and the
    loss and metrics are averaged over the processes.  Without a process
    group it is a one-process step.  The state needs an ``err_buf``."""

    def step(state: TrainState, batch: dict):
        grouped = dist.is_available() and dist.is_initialized()
        if grouped:
            batch = _rows(batch, dist.get_rank(group), dist.get_world_size(group))
        loss, metrics, grads = loss_and_grads(cfg, state.params, batch, remat=remat)
        grads, new_err = compression.psum_compressed(grads, state.err_buf, group)
        if grouped:
            loss = _pmean(loss, group)
            metrics = {k: _pmean(v, group) for k, v in metrics.items()}
        params, opt, opt_metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        return (TrainState(params, opt, state.step + 1, new_err),
                dict(metrics, **opt_metrics, loss=loss))

    return step


def state_specs(state: TrainState, mesh, *, fsdp: bool = False) -> TrainState:
    """Specs of a train state on ``mesh``: params by the sharding rules,
    the moments (and error buffers) as their params, the counters
    replicated."""
    pspecs = sharding.param_specs(state.params, mesh, fsdp=fsdp)
    return TrainState(params=pspecs,
                      opt=AdamWState(mu=pspecs, nu=pspecs, count=()),
                      step=(), err_buf=pspecs if state.err_buf is not None else None)


def place_state(state: TrainState, device_mesh, specs: TrainState) -> TrainState:
    """``state`` as DTensors on ``device_mesh`` by ``specs`` (every rank
    holding the same full state keeps its shards; placed leaves are
    redistributed)."""
    def put(tree, spec):
        return None if tree is None else sharding.place(tree, device_mesh, spec)

    return TrainState(params=put(state.params, specs.params),
                      opt=AdamWState(mu=put(state.opt.mu, specs.opt.mu),
                                     nu=put(state.opt.nu, specs.opt.nu),
                                     count=put(state.opt.count, ())),
                      step=put(state.step, ()), err_buf=put(state.err_buf, specs.err_buf))


def sharded_loss_and_grads(cfg, device_mesh, state: TrainState, batch: dict,
                           batch_specs: dict, *, remat: bool = False,
                           accum_steps: int = 1) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of the global ``batch`` for a state placed on
    ``device_mesh``, every rank computing its own rows: the data axes split
    the batch as ``batch_specs`` say (each rank keeps its slice, no data
    moves), and the rows of one data slice are split again over 'model'
    where they divide, so no two ranks repeat each other's work.  Each
    rank runs the model on its shards of the params, made whole at use and
    one layer at a time (``train.fsdp.Split``); the loss and metrics are
    averaged over the ranks (each rank's rows weigh the same) and equal on
    every rank, and the gradients are DTensors in the params' placements,
    each rank holding its shard of their mean over the ranks."""
    from torch.distributed.tensor import DTensor

    names = tuple(device_mesh.mesh_dim_names)
    m_size = device_mesh.shape[names.index("model")]
    rows = {k: v.to_local() for k, v in sharding.place(batch, device_mesh, batch_specs).items()}
    b = next(iter(rows.values())).shape[0]
    if b % (m_size * accum_steps) == 0:
        rows = _rows(rows, device_mesh.get_local_rank("model"), m_size)
    split = Split(device_mesh, tree_map(lambda p: tuple(p.placements), state.params))
    loss, metrics, grads = loss_and_grads(
        cfg, tree_map(lambda p: p.to_local(), state.params), rows, remat=remat,
        accum_steps=accum_steps, split=split)
    grads = tree_map(lambda g, p: DTensor.from_local(g, device_mesh, p.placements,
                                                     run_check=False, shape=p.shape,
                                                     stride=p.stride()),
                     grads, state.params)
    return _pmean(loss), {k: _pmean(v) for k, v in metrics.items()}, grads


def jit_train_step(cfg, opt_cfg: OptConfig, device_mesh, state: TrainState,
                   batch_example: dict, *, fsdp: bool = False, remat: bool = False,
                   accum_steps: int = 1):
    """The train step on a ``torch.distributed`` ``DeviceMesh`` with the
    reference's placements: the state by :func:`state_specs` (``fsdp``
    shards a free axis of each matrix over the data axes as well) and the
    batch by ``sharding.batch_specs``.  Returns ``step(state, batch) ->
    (state, metrics)``; a plain state is placed on the first call, the
    state comes back in the same placements, and the metrics are float32
    scalars, equal on every rank.  Every rank passes the same global batch.

    The gradients are those of :func:`sharded_loss_and_grads` (params
    all-gathered at use, gradients reduce-scattered: the FSDP pattern of
    the reference's ``fsdp=True``); their global norm is taken over the
    ranks' shards and AdamW updates each rank's shards of the params and
    moments in place.  ``step.place(state)`` places a plain state, ``step.shardings``
    is the state's tree of ``sharding.NamedSharding`` (for
    ``checkpoint.restore``).
    """
    from torch.distributed.tensor import DTensor, Replicate

    specs = state_specs(state, device_mesh, fsdp=fsdp)
    bspecs = sharding.batch_specs(device_mesh, batch_example)
    replicated = (Replicate(),) * device_mesh.ndim

    def local(tree):
        return tree_map(lambda t: t.to_local(), tree)

    def step(state: TrainState, batch: dict):
        if not isinstance(state.step, DTensor):
            state = place_state(state, device_mesh, specs)
        loss, metrics, grads = sharded_loss_and_grads(
            cfg, device_mesh, state, batch, bspecs, remat=remat, accum_steps=accum_steps)
        norm = sharded_global_norm(grads)
        shards = local(grads)
        del grads
        _, opt, opt_metrics = adamw_update(
            opt_cfg, shards, AdamWState(local(state.opt.mu), local(state.opt.nu),
                                        state.opt.count.to_local()),
            local(state.params), norm=norm)
        count = DTensor.from_local(opt.count, device_mesh, replicated, run_check=False)
        new_step = DTensor.from_local(state.step.to_local() + 1, device_mesh, replicated,
                                      run_check=False)
        return (TrainState(state.params, AdamWState(state.opt.mu, state.opt.nu, count),
                           new_step, state.err_buf),
                dict(metrics, **opt_metrics, loss=loss))

    def named(tree, spec):
        return None if tree is None else sharding.to_named(device_mesh, spec, tree)

    step.state_specs, step.batch_specs = specs, bspecs
    step.place = lambda st: place_state(st, device_mesh, specs)
    step.shardings = TrainState(
        params=named(state.params, specs.params),
        opt=AdamWState(mu=named(state.opt.mu, specs.opt.mu), nu=named(state.opt.nu, specs.opt.nu),
                       count=named(state.opt.count, ())),
        step=named(state.step, ()), err_buf=named(state.err_buf, specs.err_buf))
    return step
