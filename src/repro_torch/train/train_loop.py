"""Training step construction: gradient accumulation, activation
recomputation and the compressed data-parallel variant (port of
``repro/train/train_loop.py``).

``TrainState`` is a NamedTuple with the reference's fields (params, opt
state, step, error-feedback buffer), so checkpoints of either package
carry the same keys.  A step runs eagerly on the params' device and
updates the state's tensors in place (``optim.adamw_update``); it returns
the state and float32 scalar metrics.  The reference's ``jit_train_step``
(mesh shardings, FSDP) comes with the multi-device slice (ROADMAP.md,
Queue 1, item 10).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.optim import OptConfig, adamw_init, adamw_update, compression
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
                   accum_steps: int = 1) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of ``model_zoo.loss_fn`` (``train=True``).

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
        loss, m = model_zoo.loss_fn(cfg, aliases, mb, train=True, remat=remat)
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


def make_compressed_dp_train_step(cfg, opt_cfg: OptConfig, *, remat: bool = False,
                                  group=None):
    """Data-parallel step with the int8 error-feedback gradient mean
    (``optim.compression.psum_compressed``) over the processes of
    ``group``.  One process only, until the multi-device slice (ROADMAP.md,
    Queue 1, item 10); the state needs an ``err_buf``."""

    def step(state: TrainState, batch: dict):
        loss, metrics, grads = loss_and_grads(cfg, state.params, batch, remat=remat)
        grads, new_err = compression.psum_compressed(grads, state.err_buf, group)
        params, opt, opt_metrics = adamw_update(opt_cfg, grads, state.opt, state.params)
        return (TrainState(params, opt, state.step + 1, new_err),
                dict(metrics, **opt_metrics, loss=loss))

    return step
