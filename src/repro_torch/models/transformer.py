"""Decoder-only LM for the dense, MoE, SSM, hybrid and VLM families (port of
``repro/models/transformer.py``).

Per-layer parameters are stacked along a leading ``L`` axis, as in the
reference; the reference's ``lax.scan`` over that axis becomes a Python loop
over the ``L`` slices.  Heterogeneous local/global attention stacks (gemma,
hymba) take each layer's ``is_global`` flag from the config.  Entry points:

* ``forward``     -- full-sequence logits (no cache) and the MoE aux loss,
  with ``train`` (the QAT forward of latent weights) and ``remat``
  (activation recomputation per layer); ``loss_fn`` scores it;
* ``prefill``     -- full-sequence forward that also fills the KV/SSM caches;
* ``decode_step`` -- one token per slot at a shared length;
* ``chunk_step``  -- per-slot chunks at per-slot offsets (``chunked`` policy;
  one token per slot for the SSM and hybrid families, as in the reference);
* ``flat_step``   -- one flat ragged token batch (``flat`` policy; refused for
  the SSM and hybrid families, as in the reference).

The VLM family's vision tower is a stub, as in the reference: ``forward``
and ``prefill`` take precomputed patch embeddings ``batch["patches"]``
(B, frontend_seq, frontend_dim), project them with the dense fp
``frontend_proj`` and put them before the token embeddings, so positions
``0 .. frontend_seq - 1`` hold the patches.  The enc-dec family lives in
``models/encdec.py`` (``model_zoo`` dispatches).

``train`` selects the forward of latent ``{'w'}`` weights, as in the
reference: ``True`` (the default of ``forward`` and ``loss_fn``) runs the
straight-through QAT forward, ``False`` (the default of the serving entry
points) the exact int8 pipeline; frozen planes ignore it.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg, what: str) -> None:
    """Raise for a family this module does not build (enc-dec is
    ``models/encdec.py``'s)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(
            f"{what}: family {cfg.family!r} is not a decoder-only family "
            f"({', '.join(_FAMILIES)}); model_zoo dispatches it")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_block(cfg, generator: torch.Generator, device="cuda") -> dict:
    """One layer's latent fp32 params (the reference's ``_init_block``),
    drawn from ``generator``, which must live on ``device`` (None on
    ``meta``)."""
    _check_family(cfg, "init_block")
    dev = resolve_device(device)
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": layers.init_rmsnorm(d, dev), "ssm": ssm_lib.init_ssm(cfg, generator, dev)}
    p = {"ln1": layers.init_rmsnorm(d, dev),
         "attn": layers.init_attention(cfg, generator, dev),
         "ln2": layers.init_rmsnorm(d, dev)}
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe(cfg, generator, dev)
    else:
        p["mlp"] = layers.init_mlp(cfg, generator, dev)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_lib.init_ssm(cfg, generator, dev)
        p["ln_attn"] = layers.init_rmsnorm(d, dev)
        p["ln_ssm"] = layers.init_rmsnorm(d, dev)
    return p


def stack_layers(blocks: list):
    """Per-layer trees -> one tree with every leaf stacked along a leading
    ``L`` axis."""
    if isinstance(blocks[0], dict):
        return {k: stack_layers([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def init_head(cfg, generator: torch.Generator, device="cuda") -> dict:
    """The params outside the layer stack: the embedding, the final norm,
    untied the fp ``lm_head`` and, with a vision frontend, the dense fp
    ``frontend_proj`` (frontend_dim, d_model)."""
    dev = resolve_device(device)
    d = cfg.d_model
    params = {"embed": layers.normal(generator, (cfg.padded_vocab, d), 0.02, dev),
              "ln_f": layers.init_rmsnorm(d, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "wd": layers.normal(generator, (d, cfg.padded_vocab), 1.0 / math.sqrt(d), dev)}
    if cfg.frontend == "vision":
        params["frontend_proj"] = {
            "wd": layers.normal(generator, (cfg.frontend_dim, d),
                                1.0 / math.sqrt(cfg.frontend_dim), dev)}
    return params


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Latent fp32 params: each layer drawn by :func:`init_block`, then the
    layers stacked, as the reference's ``init_params`` builds them.
    ``generator`` must live on ``device`` (None on ``meta``).  The layout
    (and every leaf name) matches the reference's; the random numbers do
    not."""
    blocks = [init_block(cfg, generator, device) for _ in range(cfg.n_layers)]
    return {"blocks": stack_layers(blocks), **init_head(cfg, generator, device)}


def layer_slice(tree, i: int):
    """The ``i``-th layer of a stacked params (or cache) tree."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, every leaf unbound once
    along ``L``.  Its backward is one ``stack`` per leaf; slicing layer by
    layer (:func:`layer_slice`) would write a zero tensor of the whole stack
    into the gradient for every layer (2.1 GB per layer and MLP projection
    of the full-width bitnet)."""
    if isinstance(tree, dict):
        per = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _block(cfg, p: dict, x: torch.Tensor, *, flag: bool, pos: torch.Tensor, mode: str,
           train: bool = False, cache: dict | None = None, cache_len=None,
           slot: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | float,
                                                      dict | None]:
    """One layer.  ``mode``: ``"fwd"`` (no cache), ``"prefill"`` (the
    prompt's K/V written to ``cache`` from row 0, the SSM conv tail and
    final state returned) or ``"decode"`` (attention against ``cache`` with
    ``cache_len`` or ``slot``, one recurrent SSM step).  Returns (x, the MoE
    aux loss (0.0 without MoE), updated cache or None)."""
    aux = 0.0
    new_cache: dict = {}
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)

    def ssm_branch() -> torch.Tensor:
        if mode == "decode":
            y, sc = ssm_lib.ssm_decode_step(cfg, p["ssm"], h, cache, train)
            new_cache.update(sc)
            return y
        y, final = ssm_lib.ssm_forward(cfg, p["ssm"], h, train)
        if mode == "prefill":
            new_cache.update(_ssm_prefill_cache(cfg, p["ssm"], h, final, train))
        return y

    if cfg.family == "ssm":
        return x + ssm_branch(), aux, (new_cache or None)

    if mode == "decode":
        attn_out, ac = layers.attention(cfg, p["attn"], h, pos=pos, is_global=flag,
                                        cache={"k": cache["k"], "v": cache["v"]},
                                        cache_len=cache_len, slot=slot, train=train)
        new_cache.update(ac)
    elif mode == "prefill":
        attn_out, (k, v) = layers.attention(cfg, p["attn"], h, pos=pos, is_global=flag,
                                            train=train, return_kv=True)
        zero = torch.zeros((x.shape[0],), dtype=torch.long)
        new_cache.update({"k": layers.write_rows(cache["k"], k, zero),
                          "v": layers.write_rows(cache["v"], v, zero)})
    else:
        attn_out, _ = layers.attention(cfg, p["attn"], h, pos=pos, is_global=flag,
                                       train=train)

    if cfg.family == "hybrid":
        # Hymba: the mean of the per-branch normalized outputs.
        attn_out = 0.5 * (layers.rmsnorm(p["ln_attn"], attn_out, cfg.norm_eps)
                          + layers.rmsnorm(p["ln_ssm"], ssm_branch(), cfg.norm_eps))
    x = x + attn_out

    h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_lib.moe_forward(cfg, p["moe"], h2, train)
    else:
        y = layers.mlp(p["mlp"], h2, train)
    return x + y, aux, (new_cache or None)


def _ssm_prefill_cache(cfg, p: dict, h: torch.Tensor, final_state: torch.Tensor,
                       train: bool = False) -> dict:
    """Conv tail + final SSD state so decode can continue the recurrence.
    The pre-conv xBC tail is recomputed: one more ``in_proj`` call, on the
    last W-1 positions."""
    tail = h[:, -(cfg.ssm_conv_width - 1):, :]
    _, xs, bs, cs, _ = ssm_lib._split_in(cfg, layers.linear(p["in_proj"], tail, train))
    return {"conv": torch.cat([xs, bs, cs], dim=-1), "state": final_state}


def _layers(cfg, params: dict, x: torch.Tensor, cache: dict | None,
            **kw) -> tuple[torch.Tensor, torch.Tensor | float, dict | None]:
    """x through every layer (the reference's scan over the stacked
    params).  Returns (x, the summed aux loss, the per-layer caches stacked
    along ``L`` or None)."""
    new, aux = [], 0.0
    for i in range(cfg.n_layers):
        x, a, nc = _block(cfg, layer_slice(params["blocks"], i), x,
                          flag=cfg.layer_is_global(i),
                          cache=None if cache is None else layer_slice(cache, i), **kw)
        aux = aux + a
        new.append(nc)
    if cache is None:
        return x, aux, None
    return x, aux, {name: torch.stack([nc[name] for nc in new]) for name in new[0]}


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


def _embed(cfg, params: dict, tokens: torch.Tensor,
           patches: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings (B, S, D); with a vision frontend and ``patches``
    (B, P, frontend_dim), their projection by the dense ``frontend_proj``
    goes first: (B, P + S, D).  The projection is one ``torch.matmul`` (no
    kernel) summed in float64 and rounded once to float32: on the GPU a
    float32 matmul's order follows the call's shape and differs from the
    CPU's, and patch rows one ulp apart can move an int8 activation code in
    the first layer (the reason the attention core and rmsnorm sum in
    float64, ``models/layers.py``)."""
    x = params["embed"][tokens] * math.sqrt(cfg.d_model)
    if cfg.frontend == "vision" and patches is not None:
        wd = params["frontend_proj"]["wd"]
        proj = (patches.to(torch.float64) @ wd.to(torch.float64)).to(torch.float32)
        x = torch.cat([proj, x], dim=1)
    return x.to(torch.float32)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def run_layers(blocks: list, carry, layer_fn, remat: bool):
    """``carry = layer_fn(i, p, carry)`` over the per-layer trees ``blocks``
    (the reference's scan body); with ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward instead of kept, as the reference's
    ``jax.checkpoint`` with ``nothing_saveable`` does."""
    for i, p in enumerate(blocks):
        if remat:
            carry = checkpoint(layer_fn, i, p, carry, use_reentrant=False)
        else:
            carry = layer_fn(i, p, carry)
    return carry


def forward(cfg, params: dict, batch: dict, train: bool = True,
            remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, S, V) of ``batch["tokens"]`` (B, S), and the
    auxiliary loss summed over the layers (a float32 scalar tensor, 0
    without MoE layers).  A VLM batch's ``patches`` add P leading
    positions: (B, P + S, V).  ``train`` picks the latent weights' forward
    (module docstring); ``remat`` recomputes each layer's activations in the
    backward (:func:`run_layers`).  The stacked layer params are unbound
    once (:func:`unstack_layers`), so the backward stacks each leaf's
    gradient once."""
    _check_family(cfg, "forward")
    x = _embed(cfg, params, batch["tokens"], batch.get("patches"))
    pos = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(i: int, p: dict, carry: tuple) -> tuple:
        xv, a, _ = _block(cfg, p, carry[0], flag=cfg.layer_is_global(i), pos=pos,
                          mode="fwd", train=train)
        return xv, carry[1] + a

    x, aux = run_layers(unstack_layers(params["blocks"], cfg.n_layers), (x, aux),
                        layer, remat)
    return _head(cfg, params, x), aux


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``labels`` (B, S) under
    ``logits`` (B, S, V) over the positions with ``labels >= 0``."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(cfg, params: dict, batch: dict, train: bool = True,
            remat: bool = False) -> tuple[torch.Tensor, dict]:
    """(``nll + 0.01 * aux``, {"nll", "aux"}) of a batch with ``labels``
    (B, S); a VLM's leading patch positions are not scored."""
    logits, aux = forward(cfg, params, batch, train, remat=remat)
    labels = batch["labels"]
    nll = token_nll(logits[:, -labels.shape[1]:, :], labels)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


def cache_shapes(cfg, batch_size: int, max_len: int) -> dict[str, tuple]:
    """Leaf name -> shape of :func:`init_cache`: attention K/V
    (L, B, max_len, Hkv, Dh); SSM conv tail (L, B, W-1, conv_dim) and SSD
    state (L, B, H, P, N)."""
    _check_family(cfg, "init_cache")
    n_l = cfg.n_layers
    shapes = {}
    if cfg.family != "ssm":
        shapes["k"] = shapes["v"] = (n_l, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.family in ("ssm", "hybrid"):
        _, n, nh, conv_dim = ssm_lib._dims(cfg)
        shapes["conv"] = (n_l, batch_size, cfg.ssm_conv_width - 1, conv_dim)
        shapes["state"] = (n_l, batch_size, nh, cfg.ssm_head_dim, n)
    return shapes


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32,
               device="cuda") -> dict:
    """Stacked per-layer decode caches (leading axis L), zero-filled; see
    :func:`cache_shapes`."""
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in cache_shapes(cfg, batch_size, max_len).items()}


def prefill(cfg, params: dict, batch: dict, cache: dict,
            train: bool = False) -> tuple[torch.Tensor, dict]:
    """Run the prompt ``batch["tokens"]`` (B, S), after a VLM batch's P
    ``patches``: its K/V go into ``cache`` rows [0, P + S), the SSM conv
    tail and final state replace the SSM leaves.  Returns (last-position
    logits (B, 1, V), cache); the head runs on the last row only."""
    _check_family(cfg, "prefill")
    x = _embed(cfg, params, batch["tokens"], batch.get("patches"))
    pos = torch.arange(x.shape[1], device=x.device)
    x, _, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="prefill", train=train)
    return _head(cfg, params, x[:, -1:, :]), new_cache


def decode_step(cfg, params: dict, tokens: torch.Tensor, cache: dict,
                t, train: bool = False) -> tuple[torch.Tensor, dict]:
    """One decode step: ``tokens`` (B, 1) at the shared length ``t``.
    Returns (logits (B, 1, V), updated cache)."""
    _check_family(cfg, "decode_step")
    x = _embed(cfg, params, tokens)
    pos = torch.tensor([int(t)], device=x.device)
    x, _, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="decode",
                              cache_len=int(t), train=train)
    return _head(cfg, params, x), new_cache


def chunk_step(cfg, params: dict, tokens: torch.Tensor, pos: torch.Tensor, cache: dict,
               lengths: torch.Tensor, train: bool = False) -> tuple[torch.Tensor, dict]:
    """Chunked-append step for the paged serving engine (``chunked``
    policy).

    tokens (B, C) -- per-slot rows: a prefill chunk, one decode token, or
    padding; pos (B, C) -- absolute positions (padding clamped); lengths
    (B,) -- per-slot K/V write offsets.  A slot's first chunk may start at a
    nonzero offset over a pre-populated cache (a prefix-cache fork):
    attention masks by absolute position, so the chunk attends over the
    forked prefix as if the slot had prefilled it.  The SSM and hybrid
    recurrences take C == 1 only (their prompts go through ``prefill``), as
    in the reference.

    Returns (logits (B, C, V), updated cache); the head runs on every row.
    """
    _check_family(cfg, "chunk_step")
    if cfg.family in ("ssm", "hybrid") and tokens.shape[1] != 1:
        raise ValueError(f"chunk_step: the {cfg.family} recurrence takes one token per "
                         f"slot (C == 1), got C = {tokens.shape[1]}")
    x = _embed(cfg, params, tokens)
    x, _, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="decode",
                              cache_len=lengths, train=train)
    return _head(cfg, params, x), new_cache


def flat_step(cfg, params: dict, tokens: torch.Tensor, slot: torch.Tensor,
              pos: torch.Tensor, cache: dict, emit_row: torch.Tensor,
              train: bool = False) -> tuple[torch.Tensor, dict]:
    """Flat token-packed step for the paged serving engine (``flat`` policy).

    tokens/slot/pos (T,) — one ragged batch of real tokens from many slots
    (padding rows carry slot sentinel B); cache {'k','v'} (L, B, Vtok, Hk,
    Dh); emit_row (B,) — each slot's flat row whose logits it samples.
    Refused for the SSM and hybrid families: the flat layout needs
    KV-cache attention, as in the reference.

    Returns (logits (B, V) gathered at ``emit_row``, updated cache).  The
    head runs on B rows, not T.
    """
    _check_family(cfg, "flat_step")
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(f"flat_step: the {cfg.family} recurrence needs the "
                         "rectangular layout (flat needs KV-cache attention)")
    x = _embed(cfg, params, tokens)[None, :, :]
    x, _, new_cache = _layers(cfg, params, x, cache, pos=pos, mode="decode", slot=slot,
                              train=train)
    sel = x[0, emit_row]                       # (B, D) emitting rows only
    logits = _head(cfg, params, sel[None])     # (1, B, V)
    return logits[0], new_cache
