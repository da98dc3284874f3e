"""Params gathered at use and gradients reduce-scattered: the FSDP pattern
of the sharded train step (``train_loop.jit_train_step``).

Each rank of a ``DeviceMesh`` holds its shards of the params (placed by the
sharding rules) and runs forward and backward on its own rows of the batch
with plain tensors.  A :class:`Split` is what the model is handed
(``model_zoo.loss_fn(..., split=)``) to do that:

* ``gather(params, skip)`` gives the whole tensors of the params outside
  the layer stacks ``skip``, and ``layer(p, key)`` those of one layer's
  slice of the stack ``params[key]``; the layer loop calls it inside each
  layer, so under ``remat`` a layer's whole params live only while that
  layer runs, in the forward and again in the backward.  Both are
  differentiable: the backward reduce-scatters each whole gradient into
  this rank's shard and takes the mean over the ranks, so gradients are
  shard-sized;
* ``batch_mean(t)`` turns a mean over this rank's rows into the mean over
  the whole batch (the MoE balance statistics).

Routed-expert stacks split on their expert axis over 'model' (the sharding
rules' expert parallelism) stay split there: ``layer`` gathers them only
over the axes FSDP splits them on, and the MoE layer moves its tokens to
the experts instead (``exchange``, an all-to-all over the 'model' group,
``models.moe``).  Rank (d, m) then computes its own experts' gradient from
the rows of every 'model' rank of its data slice, which the all-to-all's
backward brings; summed over the data axes and divided by the ranks, it is
the whole batch's mean like every other gradient, so such a stack's
gradient is never reduced over 'model'.

On a mesh of one rank all of it is the identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# The ``*_single`` names supersede the ``*_tensor`` ones in newer torch.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _gather_dim(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``t`` along ``dim``, in group-rank order."""
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _scatter_dim(t: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over the group."""
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``t`` over the ranks of ``groups`` (all-reduced on each in
    turn); the gradient likewise."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        out = t.clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        for group in ctx.groups:
            dist.all_reduce(out, group=group)
        return out, None


class _GatherAtUse(torch.autograd.Function):
    """local shard -> whole tensor (but on the mesh axes ``keep``); the
    gradient: whole -> this rank's shard of the mean over the ranks."""

    @staticmethod
    def forward(ctx, local, split, placements, keep):
        ctx.split, ctx.placements, ctx.keep = split, placements, keep
        return split.all_gather(local, placements, keep)

    @staticmethod
    def backward(ctx, grad):
        return ctx.split.reduce_scatter(grad, ctx.placements, ctx.keep), None, None, None


class _AllToAll(torch.autograd.Function):
    """Block j of ``x``'s first dimension to rank j of ``group``, block i of
    the result from rank i; the gradient goes back the same way (the
    exchange is its own adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class Split:
    """One step's work over the ranks of ``device_mesh``; ``placements`` is
    the tree of the params' DTensor placements (module docstring)."""

    def __init__(self, device_mesh, placements: dict):
        self.mesh, self.placements = device_mesh, placements
        self.size = device_mesh.size()
        self._axes = [(i, device_mesh.shape[i], device_mesh.get_group(i))
                      for i in range(device_mesh.ndim) if device_mesh.shape[i] > 1]
        names = tuple(device_mesh.mesh_dim_names or ())
        self._model = names.index("model") if "model" in names else None
        # The 'model' ranks the routed experts are split over: the rules
        # shard nothing but an expert stack's expert axis there.
        self.ep_size, self.ep_group = 1, None
        if self._model is not None and device_mesh.shape[self._model] > 1 and any(
                pl[self._model].is_shard() for pl in _expert_placements(placements)):
            self.ep_size = device_mesh.shape[self._model]
            self.ep_group = device_mesh.get_group(self._model)

    def gather(self, params: dict, skip: tuple = ()) -> dict:
        """``params`` with every tree but the layer stacks ``skip`` whole."""
        if self.size == 1:
            return params
        return {k: v if k in skip else self._gather(v, self.placements[k], False, (k,))
                for k, v in params.items()}

    def layer(self, p, key: str):
        """One layer's slice ``p`` of the stacked tree ``params[key]``,
        whole but for routed-expert stacks split on 'model' (module
        docstring)."""
        if self.size == 1:
            return p
        return self._gather(p, self.placements[key], True, (key,))

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """The all-to-all of ``x`` over the 'model' ranks that hold the
        routed experts (:class:`_AllToAll`); differentiable."""
        return _AllToAll.apply(x, self.ep_group)

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a mean over this rank's rows, as the mean over every
        rank's (a differentiable all-reduce: each rank's gradient carries
        its rows' share, and the gradients' mean over the ranks is the
        whole batch's)."""
        if self.size == 1:
            return t
        return _SumOverRanks.apply(t, [group for _, _, group in self._axes]) / self.size

    def _expert_axis(self, path: tuple, ndim: int, placements: tuple):
        """The 'model' axis index where the leaf at ``path`` is a routed-expert
        stack split on its expert axis (``ndim - 3``) there, else None."""
        from repro_torch.train.sharding import is_expert_stack

        if (self._model is not None and is_expert_stack(path, ndim)
                and placements[self._model].is_shard(ndim - 3)):
            return self._model
        return None

    def _gather(self, tree, placements, layer: bool, path: tuple):
        if isinstance(tree, dict):
            return {k: self._gather(v, placements[k], layer, path + (k,))
                    for k, v in tree.items()}
        if layer:                   # the stack's L axis is never sharded
            if any(pl.is_shard(0) for pl in placements):
                raise ValueError("a layer stack sharded on its layer axis")
            from torch.distributed.tensor import Shard

            placements = tuple(Shard(pl.dim - 1) if pl.is_shard() else pl
                               for pl in placements)
        axis = self._expert_axis(path, tree.ndim, placements)
        return _GatherAtUse.apply(tree, self, placements, () if axis is None else (axis,))

    def all_gather(self, local: torch.Tensor, placements: tuple, keep: tuple = ()) -> torch.Tensor:
        """The whole tensor of ``local`` but on the mesh axes ``keep``: the
        minor mesh axis first, as DTensor splits a dimension sharded on
        several axes major to minor."""
        out = local
        for i, n, group in reversed(self._axes):
            if placements[i].is_shard() and i not in keep:
                out = _gather_dim(out, placements[i].dim, n, group)
        return local.view_as(local) if out is local else out

    def reduce_scatter(self, grad: torch.Tensor, placements: tuple, keep: tuple = ()) -> torch.Tensor:
        """This rank's shard of the mean of ``grad`` over the ranks: a
        reduce-scatter on each axis that shards it (major first), an
        all-reduce on each that does not; none on the axes ``keep``, whose
        ranks' gradients are of different shards."""
        out = grad
        for i, n, group in self._axes:
            if placements[i].is_shard() and i not in keep:
                out = _scatter_dim(out, placements[i].dim, n, group)
        if out is grad:
            out = grad.clone()
        for i, _, group in self._axes:
            if not placements[i].is_shard():
                dist.all_reduce(out, group=group)
        return out.div_(self.size)


def _expert_placements(tree, path: tuple = ()):
    """The placements of every routed-expert leaf of a tree of placements."""
    from repro_torch.train.sharding import is_expert_path

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _expert_placements(v, path + (k,))
    elif is_expert_path(path):
        yield tree


def global_norm(grads) -> torch.Tensor:
    """The global L2 norm of a tree of DTensors (on one mesh) from each
    rank's shards: a shard's squares count once over the ranks that hold
    copies of it."""
    from repro_torch.utils.tree import leaves

    gs = leaves(grads)
    mesh = gs[0].device_mesh
    total = torch.zeros((), dtype=torch.float32, device=gs[0].device)
    for g in gs:
        copies = 1
        for i, pl in enumerate(g.placements):
            if not pl.is_shard():
                copies *= mesh.shape[i]
        total += torch.sum(torch.square(g.to_local().to(torch.float32))) / copies
    for i in range(mesh.ndim):
        if mesh.shape[i] > 1:
            dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)
