"""AdamW with a warmup-cosine schedule and global-norm clipping (port of
``repro/optim/optimizer.py``).

Functions over nested dicts of tensors, with the reference's formula step
for step: clipped gradients, moments stored in ``moment_dtype`` (bfloat16
halves their memory) but accumulated in float32, bias correction on the
stored moments, and decoupled weight decay on leaves with ``ndim >= 2``
only.  ``torch.optim.AdamW`` is not used: it places ``eps`` and masks the
decay differently.

:func:`adamw_update` updates the params and the moments in place (the
convention of ``torch.optim``) and returns them: a full-width bitnet-2b-4t
step has no room for a second copy of its 11 GB of params and 22 GB of
moments on one 80 GB card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.utils.tree import leaves, tree_map, zeros_like


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # 'bfloat16' halves the optimizer state's memory; the moments are
    # accumulated in float32 and stored rounded.
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def cosine_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_ratio * lr``
    at ``total_steps`` (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled to a global norm of at most ``max_norm``, its norm
    before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, tree), norm


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    dev = leaves(params)[0].device
    return AdamWState(mu=zeros_like(params, moment_dtype), nu=zeros_like(params, moment_dtype),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def adamw_update(cfg: OptConfig, grads, state: AdamWState, params,
                 norm: torch.Tensor | None = None):
    """One AdamW step: ``params`` and ``state``'s moments are updated in
    place (the gradients are read, not changed).  Returns (params, the new
    ``AdamWState``, {"grad_norm", "lr"}), as the reference's pure function
    does.  ``norm`` is the gradients' global norm where ``grads`` (and
    ``params``, the moments) are one process's shards of larger tensors;
    by default it is computed from ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / (norm + 1e-9), max=1.0)
    count = state.count + 1
    b1, b2 = cfg.betas
    lr = cosine_schedule(cfg, count)
    c = count.to(torch.float32)
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    with torch.no_grad():
        for p, g, m, v in zip(*(leaves(t) for t in (params, grads, state.mu, state.nu))):
            g32 = (g * clip).to(torch.float32)
            m.copy_(b1 * m.to(torch.float32) + (1 - b1) * g32)
            v.copy_(b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32))
            del g32
            step = (m.to(torch.float32) / bc1) / (torch.sqrt(v.to(torch.float32) / bc2)
                                                  + cfg.eps)
            if p.ndim >= 2:          # decoupled weight decay on matrices only
                step = step + cfg.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * step)
    return params, AdamWState(mu=state.mu, nu=state.nu, count=count), \
        {"grad_norm": norm, "lr": lr}
