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

The reference's ``shard_map`` expert-parallel branch belongs to the
multi-device slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import bitlinear, ternary
from repro_torch.models import layers

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
        return _decode_planes(p["sign"], p["zero"], p["scale"])
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
    (B, E, C, D) bf16."""
    wg, wu, wd = (_expert_weights(p[n], train).to(torch.bfloat16)
                  for n in ("w_gate", "w_up", "w_down"))
    h = _silu_bf16(_bf16_einsum("becd,edf->becf", xe, wg)) * _bf16_einsum(
        "becd,edf->becf", xe, wu)
    return _bf16_einsum("becf,efd->becd", h, wd)


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


def _route(cfg, p: dict, x: torch.Tensor) -> dict:
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


def moe_forward(cfg, p: dict, x: torch.Tensor,
                train: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), the Switch load-balancing aux loss, a
    float32 scalar)."""
    b0, s0, d = x.shape
    if s0 > MAX_GROUP and s0 % MAX_GROUP == 0:
        x = x.reshape(b0 * (s0 // MAX_GROUP), MAX_GROUP, d)
    r = _route(cfg, p, x)
    xe = _bf16_einsum("bsec,bsd->becd", r["dispatch"], x.to(torch.bfloat16))  # (B,E,C,D)
    out_e = _expert_ffn(p, xe, train)
    y = _bf16_einsum("bsec,becd->bsd", r["combine"].to(torch.bfloat16), out_e).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + layers.mlp(p["shared"], x, train)
    return y.reshape(b0, s0, d), r["aux"]
