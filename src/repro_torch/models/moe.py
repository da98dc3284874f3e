"""Mixture-of-Experts layer: shared + routed experts, top-k routing with
per-call capacity (port of ``repro/models/moe.py``).

GShard/Switch-style dispatch spelled as einsums, as in the reference: the
router stays fp (``{'wd'}``), the routed expert stacks (E, K, M) and the
shared experts are ternary BitLinear.  Each call row dispatches
independently with capacity ``C = ceil(S * top_k * capacity_factor / E)``;
overflow tokens are dropped (the residual connection carries them).

The routed experts run the reference's function: the frozen planes are
decoded to bf16 weights on every call (latent weights are ternarized, with
a straight-through gradient when training) and the three expert products
and the dispatch and combine are bf16 einsums.  XLA computes a bf16 dot as
a float32 sum rounded once to bf16, and it spells ``silu`` on bf16 as
``1 / (1 + exp(-x))`` with every op rounded to bf16; :func:`_bf16_einsum`
and :func:`_silu_bf16` reproduce both, so the CPU port matches the
reference's expert outputs element for element at the reduced shapes.

On the GPU every sum of this module is independent of the call's row
count: the bf16 einsums and the router's logits sum in float64 and round
once (to float32, then bf16 for the einsums).  There a float32 product's
reduction order follows the call's shape, so the same token's router
logits and expert outputs moved by an ulp between the serving policies'
call layouts (4 rows alone against inside a 64-row call), enough to flip a
greedy token; the float64 sums differ far below a float32 ulp, so rounding
them once gives every layout the same bits with high probability (the
remedy of the attention core and rmsnorm, ``models/layers.py``).  On the
CPU the sums stay float32: there they equal XLA's own float32 sums bit for
bit at the reduced shapes, which a float64 sum does not (XLA's float32 sum
lands a bf16 ulp away from the exact one in about 1 of 6,000 expert
outputs).

No hand-written kernel runs here: the decode is eager PyTorch and writes the
decoded weights out (``ROADMAP.md`` lists the grouped-expert kernel that
would keep them in registers).  The shared experts go through
``layers.mlp``, so frozen ones run ``tsar_matmul``.

On a registered device mesh (``utils.act_sharding.set_mesh``), frozen
experts at inference run the reference's expert-parallel branch: each rank
decodes its own experts' planes and runs their three products on its
(data, model) block of the dispatched tokens (``local_map``, the
counterpart of the reference's ``shard_map``); ``EP_CALLS`` counts them.

In the sharded train step (a ``train.fsdp.Split`` whose expert stacks stay
split over 'model') each rank holds E / msz experts and its own rows: the
dispatched tokens go to the experts' ranks by an all-to-all over the
'model' group and come back by another (the reference's "dispatch =
all-to-all", there chosen by XLA from the pinned layouts), and the
combine runs locally (:func:`_expert_ffn_exchanged`).  A row's expert sums
are those of one process: regrouping rows moves no sum.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import bitlinear, ternary
from repro_torch.models import layers
from repro_torch.utils import act_sharding
from repro_torch.utils.act_sharding import constrain

# Calls of the expert-parallel branch of :func:`_expert_ffn`, and the
# training forward's token all-to-alls (:func:`_expert_ffn_exchanged`).
EP_CALLS = {"expert_parallel": 0, "all_to_all": 0}

# Dispatch-group size: a call row longer than this (and a multiple of it) is
# regrouped into rows of this many tokens, so the (rows, G, E, C) dispatch
# tensor stays O(tokens * G * cf).
MAX_GROUP = 4096


def init_moe(cfg, generator: torch.Generator, dev: torch.device) -> dict:
    """Latent params: the fp router ``{'wd'}`` (d, E), the routed expert
    stacks ``{'w'}`` (E, K, M) (``{'wd'}`` for a non-ternary config) and,
    with ``n_shared_experts``, one gated MLP of width
    ``d_expert * n_shared_experts``."""
    d = cfg.d_model
    de = cfg.d_expert or cfg.d_ff
    e = cfg.n_experts
    tern = cfg.ternary

    def expert_stack(kin: int, kout: int) -> dict:
        w = layers.normal(generator, (e, kin, kout), 1.0 / math.sqrt(kin), dev)
        return {"w": w} if tern else {"wd": w}

    p = {"router": {"wd": layers.normal(generator, (d, e), 0.02, dev)},
         "w_gate": expert_stack(d, de), "w_up": expert_stack(d, de),
         "w_down": expert_stack(de, d)}
    if cfg.n_shared_experts:
        ds = de * cfg.n_shared_experts
        p["shared"] = {"w_gate": layers.init_linear(generator, d, ds, dev, tern),
                       "w_up": layers.init_linear(generator, d, ds, dev, tern),
                       "w_down": layers.init_linear(generator, ds, d, dev, tern)}
    return p


def _decode_planes(sign: torch.Tensor, zero: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """(E, K//8, M) uint8 planes and (E, M) scales -> (E, K, M) bf16
    effective weights ``t * bf16(scale)``, through uint8/int8 (no wider
    intermediate: one layer's full-width stacks hold 553.6 M weights)."""
    e, kb, m = sign.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=sign.device).reshape(1, 1, 8, 1)

    def bits(plane: torch.Tensor) -> torch.Tensor:
        return ((plane[:, :, None, :] >> shifts) & 1).reshape(e, kb * 8, m).to(torch.int8)

    t = ((1 - 2 * bits(sign)) * (1 - bits(zero))).to(torch.bfloat16)
    return t * scale[:, None, :].to(torch.bfloat16)


def _expert_weights(p: dict, train: bool = True) -> torch.Tensor:
    """Effective expert weights (E, K, M) from dense ``{'wd'}``, latent
    ``{'w'}`` (``train``: the straight-through ternarization, else
    ``t * scale``) or frozen planes."""
    if "wd" in p:
        return p["wd"]
    if "w" in p:
        if train:
            return bitlinear.ste_ternarize(p["w"])
        t, scale = ternary.absmean_ternarize(p["w"])
        return t * scale[..., None, :]
    if "sign" in p:
        return constrain(_decode_planes(p["sign"], p["zero"], p["scale"]),
                         "expert_weights")
    raise ValueError(f"unrecognized expert params: {list(p)}")


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype this module's sums run in: float64 on the GPU, float32 on
    the CPU (see the module docstring); a meta tensor (the dry-run) takes
    the GPU's."""
    return torch.float32 if x.device.type == "cpu" else torch.float64


def _bf16_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of bf16 operands rounded to bf16, as XLA computes a bf16
    dot (a float32 sum rounded once); on the GPU summed in float64 and
    rounded to float32 first, so the result does not depend on the call's
    shape (see the module docstring)."""
    acc = _sum_dtype(a)
    return torch.einsum(eq, a.to(acc), b.to(acc)).to(torch.float32).to(torch.bfloat16)


def _silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` on bf16 with every op rounded to bf16, the
    sigmoid spelled ``1 / (1 + exp(-x))`` as XLA expands it."""
    return x * (1 / (1 + torch.exp(-x)))


def _expert_ffn(p: dict, xe: torch.Tensor, train: bool = True) -> torch.Tensor:
    """Routed-expert FFN on dispatched tokens xe (B, E, C, D) bf16 ->
    (B, E, C, D) bf16.

    For frozen experts at inference on a registered mesh (E divisible by
    'model', B by the data axes, xe a DTensor), the decode and the three
    products run per rank on its local experts and its block of xe
    (:func:`_expert_ffn_local`)."""
    mesh = act_sharding.get_mesh()
    if (mesh is not None and "sign" in p["w_gate"] and not train
            and act_sharding.is_dtensor(xe)
            and xe.shape[1] % act_sharding._size(mesh, "model") == 0
            and xe.shape[0] % act_sharding._dsize(mesh) == 0):
        return _expert_ffn_local(p, xe, mesh)
    return _expert_math(p, xe, train)


def _expert_math(p: dict, xe: torch.Tensor, train: bool) -> torch.Tensor:
    wg, wu, wd = (_expert_weights(p[n], train).to(torch.bfloat16)
                  for n in ("w_gate", "w_up", "w_down"))
    h = _silu_bf16(_bf16_einsum("becd,edf->becf", xe, wg)) * _bf16_einsum(
        "becd,edf->becf", xe, wu)
    return _bf16_einsum("becf,efd->becd", h, wd)


def _expert_ffn_local(p: dict, xe, mesh):
    """The expert-parallel branch: fully manual over (data..., model), as
    the reference's ``shard_map`` is.  xe is sharded (data axes, 'model')
    on (B, E); the planes and scales on E over 'model', replicated over
    the data axes: each rank decodes only its own experts."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    dax = act_sharding._dax(mesh)
    xpl = tuple(Shard(1) if n == "model" else Shard(0) if n in dax else Replicate()
                for n in names)
    ew = tuple(Shard(0) if n == "model" else Replicate() for n in names)

    def local_block(xe_l, gs, gz, gsc, us, uz, usc, ds, dz, dsc):
        EP_CALLS["expert_parallel"] += 1
        planes = {"w_gate": {"sign": gs, "zero": gz, "scale": gsc},
                  "w_up": {"sign": us, "zero": uz, "scale": usc},
                  "w_down": {"sign": ds, "zero": dz, "scale": dsc}}
        return _expert_math(planes, xe_l, train=False)

    fn = local_map(local_block, out_placements=list(xpl), in_placements=(xpl,) + (ew,) * 9,
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(xe, *(p[n][leaf] for n in ("w_gate", "w_up", "w_down")
                    for leaf in ("sign", "zero", "scale")))


def _expert_ffn_exchanged(p: dict, xe: torch.Tensor, train: bool, split) -> torch.Tensor:
    """:func:`_expert_math` of this rank's dispatched tokens xe (B, E, C, D)
    on the experts of every 'model' rank of ``split``, this rank holding
    E / msz of them: expert block j of xe goes to rank j, which runs its
    experts on (msz * B, E / msz, C, D) rows, and the outputs come back
    (two all-to-alls, differentiable through ``split.exchange``)."""
    n = split.ep_size
    b, e, c, d = xe.shape
    el = next(iter(p["w_gate"].values())).shape[-3]
    if el * n != e:
        raise ValueError(f"{e} experts do not split as {el} per rank over {n} 'model' ranks")
    EP_CALLS["all_to_all"] += 2
    rows = split.exchange(xe.reshape(b, n, el, c, d).transpose(0, 1))   # (msz, B, El, C, D)
    out = _expert_math(p, rows.reshape(n * b, el, c, d), train)
    back = split.exchange(out.reshape(n, b, el, c, d))
    return back.transpose(0, 1).reshape(b, e, c, d)


def _top_k(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates and their indices, ties ordered toward the lower
    index as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The fp router's float32 logits of x (B, S, D); on the GPU summed in
    float64 and rounded once (see the module docstring)."""
    acc = _sum_dtype(x)
    return (x.to(acc) @ p["wd"].to(acc)).to(torch.float32)


def _route(cfg, p: dict, x: torch.Tensor, split=None) -> dict:
    """Router of one call, x (B, S, D) -> ``gates`` (B, S, E) f32, the
    renormalised ``topw`` and ``topi`` (B, S, k), the one-hot ``dispatch``
    (B, S, E, C) bf16 and ``combine`` (B, S, E, C) f32 tensors with
    ``C = ceil(S * k * capacity_factor / E)``, and the Switch ``aux`` loss."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(1, math.ceil(s * k * cfg.capacity_factor / e))
    dev = x.device

    gates = torch.softmax(_router_logits(p["router"], x), dim=-1)
    topw, topi = _top_k(gates, k)
    topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)

    # Load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e.
    me = torch.mean(gates, dim=(0, 1))
    ce = torch.mean(torch.sum(F.one_hot(topi, e).to(gates.dtype), dim=2), dim=(0, 1))
    if split is not None:        # over the whole batch, not this rank's rows
        me, ce = split.batch_mean(me), split.batch_mean(ce)
    aux = e * torch.sum(me * ce)

    # Position-in-expert via per-slot cumsum (slots in priority order).  A
    # token picks an expert at most once, so every (s, e, c) cell receives
    # at most one entry: the sums below are exact.
    dispatch = torch.zeros((b, s, e, cap), dtype=torch.bfloat16, device=dev)
    combine = torch.zeros((b, s, e, cap), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, 1, e), dtype=torch.int64, device=dev)
    positions = torch.arange(cap, device=dev)
    for j in range(k):
        oh = F.one_hot(topi[..., j], e)                            # (B,S,E)
        pos_in_e = torch.cumsum(oh, dim=1) - 1 + counts
        counts = counts + torch.sum(oh, dim=1, keepdim=True)
        keep = (pos_in_e < cap) & (oh > 0)
        sel = ((pos_in_e[..., None] == positions) & keep[..., None]).to(torch.bfloat16)
        dispatch = dispatch + sel
        combine = combine + sel.to(torch.float32) * topw[..., j, None, None]
    return {"gates": gates, "topw": topw, "topi": topi, "dispatch": dispatch,
            "combine": combine, "aux": aux.to(torch.float32)}


def moe_forward(cfg, p: dict, x: torch.Tensor, train: bool = True,
                split=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), the Switch load-balancing aux loss, a
    float32 scalar).  With a ``split`` (``train.fsdp.Split``) x is this
    rank's rows of the batch, the aux loss takes its statistics over the
    whole batch, and where the split keeps the routed experts on their
    'model' ranks the tokens go to them (:func:`_expert_ffn_exchanged`)."""
    b0, s0, d = x.shape
    if s0 > MAX_GROUP and s0 % MAX_GROUP == 0:
        x = x.reshape(b0 * (s0 // MAX_GROUP), MAX_GROUP, d)
    r = _route(cfg, p, x, split)
    xe = _bf16_einsum("bsec,bsd->becd", r["dispatch"], x.to(torch.bfloat16))  # (B,E,C,D)
    xe = constrain(xe, "moe")        # expert axis on 'model': the dispatch is an all-to-all
    if split is not None and split.ep_size > 1:
        out_e = _expert_ffn_exchanged(p, xe, train, split)
    else:
        out_e = constrain(_expert_ffn(p, xe, train), "moe")
    # On a mesh the expert axis is gathered before the combine: summed as
    # per-rank partials, the combine's float32 sum over the experts would
    # take another order and move bf16 roundings.
    y = _bf16_einsum("bsec,becd->bsd", r["combine"].to(torch.bfloat16),
                     act_sharding.unshard(out_e, 1)).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + layers.mlp(p["shared"], x, train)
    return y.reshape(b0, s0, d), r["aux"]
