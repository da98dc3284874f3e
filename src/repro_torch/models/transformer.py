"""Decoder-only LM for the dense family (port of
``repro/models/transformer.py``).

Per-layer parameters are stacked along a leading ``L`` axis, as in the
reference; the reference's ``lax.scan`` over that axis becomes a Python loop
over the ``L`` slices.  Only the serving entry point ``flat_step`` is ported
so far.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape: tuple, std: float,
            dev: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * std


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Latent fp32 params, stacked per layer.  ``generator`` must live on
    ``device``.  The layout (and every leaf name) matches the reference's
    ``init_params``; the random numbers do not."""
    if cfg.family != "dense" or cfg.is_moe or not cfg.ternary:
        raise NotImplementedError(
            f"init_params: only the dense ternary family is ported "
            f"(got {cfg.name!r})")
    dev = resolve_device(device)
    n_l, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def lin(k: int, m: int) -> dict:
        return {"w": _normal(generator, (n_l, k, m), 1.0 / math.sqrt(k), dev)}

    def norm(width: int) -> dict:
        return {"g": torch.zeros((n_l, width), dtype=torch.float32, device=dev)}

    attn = {"wq": lin(d, h * dh), "wk": lin(d, hk * dh),
            "wv": lin(d, hk * dh), "wo": lin(h * dh, d)}
    if cfg.qk_norm:
        attn["qn"], attn["kn"] = norm(dh), norm(dh)
    if cfg.mlp_gated:
        mlp = {"w_gate": lin(d, f), "w_up": lin(d, f), "w_down": lin(f, d)}
    else:
        mlp = {"w_up": lin(d, f), "w_down": lin(f, d)}
    params = {
        "blocks": {"ln1": norm(d), "attn": attn, "ln2": norm(d), "mlp": mlp},
        "embed": _normal(generator, (cfg.padded_vocab, d), 0.02, dev),
        "ln_f": {"g": torch.zeros((d,), dtype=torch.float32, device=dev)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "wd": _normal(generator, (d, cfg.padded_vocab), 1.0 / math.sqrt(d), dev)}
    return params


def layer_slice(tree, i: int):
    """The ``i``-th layer of a stacked params (or cache) tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _block(cfg, p: dict, x: torch.Tensor, *, flag: bool, pos: torch.Tensor,
           cache: dict, slot: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One dense layer in the flat decode layout (the reference's
    ``mode="decode"`` with ``slot``).  Returns (x, updated cache)."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn_out, new_cache = layers.attention(cfg, p["attn"], h, pos=pos,
                                           is_global=flag, cache=cache, slot=slot)
    x = x + attn_out
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h2), new_cache


def _head(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]["wd"].to(x.dtype)
    logits = layers.softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:   # mask the padding columns
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.finfo(logits.dtype).min)
    return logits


def flat_step(cfg, params: dict, tokens: torch.Tensor, slot: torch.Tensor,
              pos: torch.Tensor, cache: dict,
              emit_row: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Flat token-packed step for the paged serving engine (``flat`` policy).

    tokens/slot/pos (T,) — one ragged batch of real tokens from many slots
    (padding rows carry slot sentinel B); cache {'k','v'} (L, B, Vtok, Hk,
    Dh); emit_row (B,) — each slot's flat row whose logits it samples.

    Returns (logits (B, V) gathered at ``emit_row``, updated cache).  The
    head runs on B rows, not T.
    """
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"flat_step: only the dense family is ported (got {cfg.family!r})")
    x = params["embed"][tokens][None, :, :] * math.sqrt(cfg.d_model)
    x = x.to(torch.float32)
    new_k, new_v = [], []
    for i in range(cfg.n_layers):
        x, nc = _block(cfg, layer_slice(params["blocks"], i), x,
                       flag=cfg.layer_is_global(i), pos=pos,
                       cache=layer_slice(cache, i), slot=slot)
        new_k.append(nc["k"])
        new_v.append(nc["v"])
    sel = x[0, emit_row]                       # (B, D) emitting rows only
    logits = _head(cfg, params, sel[None])     # (1, B, V)
    return logits[0], {"k": torch.stack(new_k), "v": torch.stack(new_v)}
