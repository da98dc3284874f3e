"""Encoder-decoder backbone for the ``whisper-tiny`` family (port of
``repro/models/encdec.py``).

The audio conv frontend is a stub, as in the reference: the model takes
precomputed frame embeddings ``batch["frames"]`` (B, enc_seq, d_model).
The encoder is a non-causal self-attention stack; each decoder layer runs
causal self-attention, cross-attention over the encoder output, and the
MLP.  The decode caches are the self-attention K/V (``k``/``v``, one row per
position) and the cross-attention K/V (``xk``/``xv``, enc_seq rows), which
the prefill computes once from the encoder output and every decode step
reuses unchanged.  The reference's ``lax.scan`` over the stacked layers is a
Python loop.  ``forward`` and ``loss_fn`` take the reference's ``train`` and
``remat`` (the decoder layers recomputed in the backward), the serving entry
points ``train=False`` (see ``models/transformer.py``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.transformer import (embed_rows, layer_slice, run_layers, stack_layers,
                                            token_nll, unstack_layers)
from repro_torch.utils.act_sharding import constrain, unshard


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_enc_block(cfg, generator: torch.Generator, dev: torch.device) -> dict:
    d = cfg.d_model
    return {"ln1": layers.init_rmsnorm(d, dev),
            "attn": layers.init_attention(cfg, generator, dev),
            "ln2": layers.init_rmsnorm(d, dev),
            "mlp": layers.init_mlp(cfg, generator, dev)}


def init_dec_block(cfg, generator: torch.Generator, dev: torch.device) -> dict:
    d = cfg.d_model
    return {"ln1": layers.init_rmsnorm(d, dev),
            "attn": layers.init_attention(cfg, generator, dev),
            "ln_x": layers.init_rmsnorm(d, dev),
            "xattn": layers.init_attention(cfg, generator, dev, cross=True),
            "ln2": layers.init_rmsnorm(d, dev),
            "mlp": layers.init_mlp(cfg, generator, dev)}


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Latent fp32 params in the reference's layout: each encoder and
    decoder layer drawn on its own, then stacked along a leading ``L``
    axis; the tied embedding and the two final norms.  ``generator`` must
    live on ``device``; the random numbers differ from the reference's."""
    dev = resolve_device(device)
    enc = [init_enc_block(cfg, generator, dev) for _ in range(cfg.n_enc_layers)]
    dec = [init_dec_block(cfg, generator, dev) for _ in range(cfg.n_layers)]
    return {"enc_blocks": stack_layers(enc), "dec_blocks": stack_layers(dec),
            "embed": layers.normal(generator, (cfg.padded_vocab, cfg.d_model), 0.02, dev),
            "ln_enc": layers.init_rmsnorm(cfg.d_model, dev),
            "ln_f": layers.init_rmsnorm(cfg.d_model, dev)}


# ---------------------------------------------------------------------------
# Encoder, decoder layer, head
# ---------------------------------------------------------------------------

def encode(cfg, params: dict, frames: torch.Tensor, train: bool = True,
           split=None) -> torch.Tensor:
    """frames (B, T, D) stub embeddings -> encoder states (B, T, D); with a
    ``split`` each layer's params made whole at use (``transformer.forward``)."""
    x = frames.to(torch.float32)
    pos = torch.arange(x.shape[1], device=x.device)
    for p in unstack_layers(params["enc_blocks"], cfg.n_enc_layers):
        if split is not None:
            p = split.layer(p, "enc_blocks")
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        a, _ = layers.attention(cfg, p["attn"], h, pos=pos, is_global=True, causal=False,
                                train=train)
        x = x + a
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h, train)
    return layers.rmsnorm(params["ln_enc"], x, cfg.norm_eps)


def _dec_block(cfg, p: dict, x: torch.Tensor, enc_out: torch.Tensor | None, *,
               pos: torch.Tensor, mode: str, train: bool = False,
               cache: dict | None = None, cache_len=None) -> tuple[torch.Tensor, dict | None]:
    """One decoder layer.  ``mode``: ``"fwd"`` (no cache), ``"prefill"``
    (the prompt's K/V written to ``cache`` from row 0 and the cross K/V
    computed from ``enc_out``) or ``"decode"`` (self-attention against the
    cache at ``cache_len``, cross-attention against the cached ``xk``/
    ``xv``).  Returns (x, the layer's updated cache or None)."""
    new_cache: dict = {}
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        a, ac = layers.attention(cfg, p["attn"], h, pos=pos, is_global=True,
                                 cache={"k": cache["k"], "v": cache["v"]},
                                 cache_len=cache_len, train=train)
        new_cache.update(ac)
    elif mode == "prefill":
        a, (k, v) = layers.attention(cfg, p["attn"], h, pos=pos, is_global=True,
                                     train=train, return_kv=True)
        zero = torch.zeros((x.shape[0],), dtype=torch.long)
        new_cache.update({"k": layers.write_rows(cache["k"], k, zero),
                          "v": layers.write_rows(cache["v"], v, zero)})
    else:
        a, _ = layers.attention(cfg, p["attn"], h, pos=pos, is_global=True, train=train)
    x = x + a

    h = layers.rmsnorm(p["ln_x"], x, cfg.norm_eps)
    if mode == "decode":
        xa = _cross_from_cache(cfg, p["xattn"], h, cache["xk"], cache["xv"], train)
        new_cache.update({"xk": cache["xk"], "xv": cache["xv"]})
    else:
        xa, (xk, xv) = layers.attention(cfg, p["xattn"], h, pos=pos, is_global=True,
                                        kv_x=enc_out, causal=False, train=train,
                                        return_kv=True)
        if mode == "prefill":
            new_cache.update({"xk": xk.to(cache["xk"].dtype),
                              "xv": xv.to(cache["xv"].dtype)})
    x = x + xa

    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + layers.mlp(p["mlp"], h, train), (new_cache or None)


def _cross_from_cache(cfg, p: dict, x: torch.Tensor, xk: torch.Tensor,
                      xv: torch.Tensor, train: bool = False) -> torch.Tensor:
    """Cross-attention of x (B, S, D) against the cached encoder K/V
    (B, T, Hk, Dh).  The scores, softmax and weighted sum are the attention
    core's (``layers.context``: float64, rounded once; per rank on a
    mesh), so a decode step attends over the encoder exactly as the
    prefill's cross-attention does."""
    h_, dh = cfg.n_heads, cfg.head_dim
    b, s, _ = x.shape
    q = layers.split_heads(layers.linear(p["wq"], x, train), h_, dh)
    ctx = layers.context(cfg, q, xk, xv, None, x.dtype)
    return layers.linear(p["wo"], ctx.reshape(b, s, h_ * dh), train)


def _head(cfg, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the tied embedding; padded vocab columns are set to
    the float32 minimum."""
    x = unshard(layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), 0)   # see transformer._head
    logits = constrain(x @ constrain(params["embed"], "vocab_rows").T, "logits")
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.finfo(logits.dtype).min)
    return logits


def _embed(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = (embed_rows(params["embed"], tokens) * math.sqrt(cfg.d_model)).to(torch.float32)
    return constrain(x, "residual")            # see transformer._embed


def _decoder(cfg, params: dict, x: torch.Tensor, enc_out: torch.Tensor | None,
             cache: dict | None, **kw) -> tuple[torch.Tensor, dict | None]:
    """x through every decoder layer; the per-layer caches stacked along
    ``L`` (None without a cache)."""
    new = []
    for i in range(cfg.n_layers):
        x, nc = _dec_block(cfg, layer_slice(params["dec_blocks"], i), x, enc_out,
                           cache=None if cache is None else layer_slice(cache, i), **kw)
        new.append(nc)
    if cache is None:
        return x, None
    return x, {name: torch.stack([nc[name] for nc in new]) for name in new[0]}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward(cfg, params: dict, batch: dict, train: bool = True,
            remat: bool = False, split=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, S, V) of ``batch["tokens"]`` given
    ``batch["frames"]``, and the aux loss (0, as in the reference).
    ``remat`` recomputes each decoder layer in the backward, as the
    reference does (its encoder is not rematerialized).  ``split``: see
    ``transformer.forward``."""
    if split is not None:
        params = split.gather(params, skip=("enc_blocks", "dec_blocks"))
    enc_out = encode(cfg, params, batch["frames"], train, split=split)
    x = _embed(cfg, params, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)

    def layer(i: int, p: dict, xv: torch.Tensor) -> torch.Tensor:
        if split is not None:
            p = split.layer(p, "dec_blocks")
        return _dec_block(cfg, p, xv, enc_out, pos=pos, mode="fwd", train=train)[0]

    x = run_layers(unstack_layers(params["dec_blocks"], cfg.n_layers), x, layer, remat)
    return _head(cfg, params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg, params: dict, batch: dict, train: bool = True,
            remat: bool = False, split=None) -> tuple[torch.Tensor, dict]:
    """(nll, {"nll", "aux"}) of a batch with ``labels`` (B, S); no aux term,
    as in the reference."""
    logits, aux = forward(cfg, params, batch, train, remat=remat, split=split)
    nll = token_nll(logits, batch["labels"])
    return nll, {"nll": nll, "aux": aux}


def cache_shapes(cfg, batch_size: int, max_len: int) -> dict[str, tuple]:
    """Leaf name -> shape of :func:`init_cache`: self-attention K/V
    (L, B, max_len, Hkv, Dh), cross-attention K/V (L, B, enc_seq, Hkv, Dh)."""
    n_l, hk, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    own = (n_l, batch_size, max_len, hk, dh)
    cross = (n_l, batch_size, cfg.enc_seq, hk, dh)
    return {"k": own, "v": own, "xk": cross, "xv": cross}


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32,
               device="cuda") -> dict:
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in cache_shapes(cfg, batch_size, max_len).items()}


def prefill(cfg, params: dict, batch: dict, cache: dict,
            train: bool = False) -> tuple[torch.Tensor, dict]:
    """Encode ``batch["frames"]`` and run the prompt ``batch["tokens"]``
    (B, S): its K/V go into cache rows [0, S), the cross K/V replace
    ``xk``/``xv``.  Returns (last-position logits (B, 1, V), cache)."""
    enc_out = encode(cfg, params, batch["frames"], train)
    x = _embed(cfg, params, batch["tokens"])
    pos = torch.arange(x.shape[1], device=x.device)
    x, new_cache = _decoder(cfg, params, x, enc_out, cache, pos=pos, mode="prefill",
                            train=train)
    return _head(cfg, params, x[:, -1:, :]), new_cache


def decode_step(cfg, params: dict, tokens: torch.Tensor, cache: dict,
                t, train: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step: ``tokens`` (B, 1) at the shared length ``t``."""
    x = _embed(cfg, params, tokens)
    pos = torch.tensor([int(t)], device=x.device)
    x, new_cache = _decoder(cfg, params, x, None, cache, pos=pos, mode="decode",
                            cache_len=int(t), train=train)
    return _head(cfg, params, x), new_cache


def chunk_step(cfg, params: dict, tokens: torch.Tensor, pos: torch.Tensor, cache: dict,
               lengths: torch.Tensor, train: bool = False) -> tuple[torch.Tensor, dict]:
    """Per-slot step for the paged serving engine: tokens/pos (B, C),
    lengths (B,) per-slot K/V write offsets; the cross K/V cached at
    prefill are reused unchanged.  Returns (logits (B, C, V), cache)."""
    x = _embed(cfg, params, tokens)
    x, new_cache = _decoder(cfg, params, x, None, cache, pos=pos, mode="decode",
                            cache_len=lengths, train=train)
    return _head(cfg, params, x), new_cache

