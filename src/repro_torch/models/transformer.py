"""Decoder-only LM for the dense family (port of
``repro/models/transformer.py``).

Per-layer parameters are stacked along a leading ``L`` axis, as in the
reference; the reference's ``lax.scan`` over that axis becomes a Python loop
over the ``L`` slices.  Entry points:

* ``forward``     -- full-sequence logits (no cache);
* ``prefill``     -- full-sequence forward that also fills a KV cache;
* ``decode_step`` -- one token per slot at a shared length;
* ``chunk_step``  -- per-slot chunks at per-slot offsets (``chunked`` policy);
* ``flat_step``   -- one flat ragged token batch (``flat`` policy).

``loss_fn`` and rematerialization wait for the training slice.
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

def _dense_only(cfg, what: str) -> None:
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(
            f"{what}: only the dense family is ported (got {cfg.family!r})")


def _block(cfg, p: dict, x: torch.Tensor, *, flag: bool, pos: torch.Tensor, mode: str,
           cache: dict | None = None, cache_len=None,
           slot: torch.Tensor | None = None) -> tuple[torch.Tensor, dict | None]:
    """One dense layer.  ``mode``: ``"fwd"`` (no cache), ``"prefill"`` (the
    prompt's K/V written to ``cache`` from row 0) or ``"decode"`` (attention
    against ``cache`` with ``cache_len`` or ``slot``).  Returns (x, updated
    cache or None)."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    new_cache = None
    if mode == "decode":
        attn_out, new_cache = layers.attention(cfg, p["attn"], h, pos=pos, is_global=flag,
                                               cache=cache, cache_len=cache_len, slot=slot)
    elif mode == "prefill":
        attn_out, (k, v) = layers.attention(cfg, p["attn"], h, pos=pos, is_global=flag,
                                            return_kv=True)
        zero = torch.zeros((x.shape[0],), dtype=torch.long)
        new_cache = {"k": layers.write_rows(cache["k"], k, zero),
                     "v": layers.write_rows(cache["v"], v, zero)}
    else:
        attn_out, _ = layers.attention(cfg, p["attn"], h, pos=pos, is_global=flag)
    x = x + attn_out
    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h2), new_cache


def _layers(cfg, params: dict, x: torch.Tensor, cache: dict | None,
            **kw) -> tuple[torch.Tensor, dict | None]:
    """x through every layer (the reference's scan over the stacked
    params); the per-layer caches come back stacked along ``L``."""
    new = []
    for i in range(cfg.n_layers):
        x, nc = _block(cfg, layer_slice(params["blocks"], i), x,
                       flag=cfg.layer_is_global(i),
                       cache=None if cache is None else layer_slice(cache, i), **kw)
        new.append(nc)
    if cache is None:
        return x, None
    return x, {name: torch.stack([nc[name] for nc in new]) for name in new[0]}


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


def _embed(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return (params["embed"][tokens] * math.sqrt(cfg.d_model)).to(torch.float32)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(cfg, params: dict, batch: dict) -> tuple[torch.Tensor, float]:
    """Teacher-forced logits (B, S, V) of ``batch["tokens"]`` (B, S), and the
    auxiliary loss (0 for the dense family)."""
    _dense_only(cfg, "forward")
    x = _embed(cfg, params, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)
    x, _ = _layers(cfg, params, x, None, pos=pos, mode="fwd")
    return _head(cfg, params, x), 0.0


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32,
               device="cuda") -> dict:
    """Stacked per-layer K/V caches (L, B, max_len, Hkv, Dh), zero-filled."""
    _dense_only(cfg, "init_cache")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(cfg, params: dict, batch: dict, cache: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt ``batch["tokens"]`` (B, S) and write its K/V into
    ``cache`` rows [0, S).  Returns (last-position logits (B, 1, V), cache);
    the head runs on the last row only."""
    _dense_only(cfg, "prefill")
    x = _embed(cfg, params, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)
    x, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="prefill")
    return _head(cfg, params, x[:, -1:, :]), new_cache


def decode_step(cfg, params: dict, tokens: torch.Tensor, cache: dict,
                t) -> tuple[torch.Tensor, dict]:
    """One decode step: ``tokens`` (B, 1) at the shared length ``t``.
    Returns (logits (B, 1, V), updated cache)."""
    _dense_only(cfg, "decode_step")
    x = _embed(cfg, params, tokens)
    pos = torch.tensor([int(t)], device=x.device)
    x, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="decode", cache_len=int(t))
    return _head(cfg, params, x), new_cache


def chunk_step(cfg, params: dict, tokens: torch.Tensor, pos: torch.Tensor, cache: dict,
               lengths: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Chunked-append step for the paged serving engine (``chunked``
    policy).

    tokens (B, C) -- per-slot rows: a prefill chunk, one decode token, or
    padding; pos (B, C) -- absolute positions (padding clamped); lengths
    (B,) -- per-slot K/V write offsets.  A slot's first chunk may start at a
    nonzero offset over a pre-populated cache (a prefix-cache fork):
    attention masks by absolute position, so the chunk attends over the
    forked prefix as if the slot had prefilled it.

    Returns (logits (B, C, V), updated cache); the head runs on every row.
    """
    _dense_only(cfg, "chunk_step")
    x = _embed(cfg, params, tokens)
    x, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="decode", cache_len=lengths)
    return _head(cfg, params, x), new_cache


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
    _dense_only(cfg, "flat_step")
    x = _embed(cfg, params, tokens)[None, :, :]
    x, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="decode", slot=slot)
    sel = x[0, emit_row]                       # (B, D) emitting rows only
    logits = _head(cfg, params, sel[None])     # (1, B, V)
    return logits[0], new_cache
