"""Transformer building blocks (port of ``repro/models/layers.py``).

Params are plain dicts of tensors.  Every projection goes through
:func:`linear`, which dispatches on the param dict: ``{'sign','zero',
'scale'}`` = frozen 2-bit T-SAR planes (the serving path, through the
hand-written kernels and the active execution plan), ``{'wd'}`` = plain
dense fp.

Only the flat token-packed attention branch (the serving engine's ``flat``
policy) is ported; the legacy-decode, chunked and full-sequence branches,
and the latent ``{'w'}`` QAT forward, are later slices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import ternary
from repro_torch.kernels import ops
from repro_torch.plan import registry
from repro_torch.plan import runtime as plan_runtime
from repro_torch.sparse import format as sparse_format


# ---------------------------------------------------------------------------
# Linear dispatch
# ---------------------------------------------------------------------------

def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "wd" in p:
        return x @ p["wd"].to(x.dtype)
    if "sign" in p:  # frozen packed planes: decode-in-registers kernel
        return _packed_linear(p, x).to(x.dtype)
    if "w" in p:
        raise NotImplementedError(
            "latent {'w'} BitLinear forward is not ported yet (training "
            "slice); freeze the params with serving.freeze_params first")
    raise ValueError(f"unrecognized linear params: {list(p)}")


def _packed_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Inference forward from 2-bit planes, dispatched through the active
    execution plan (``repro_torch.plan.runtime``), as the reference's is.

    The planned kernel for this layer's (k, m) at the step's token count
    decides the realization, resolved with Python dicts only:

    * a planned sparse kernel is remapped within the sparse family to the
      format the leaves carry (the compacted ``tsar_sparse`` cannot ride a
      params tree), and with ``sp_*`` padded-pool leaves it runs
      ``tsar_sparse_padded`` through the registry: the hand-written sparse
      kernel, reading the weights from the pool;
    * planned ``dense`` and ``memory_lut`` run their registry lowerings;
    * everything else (``tsar_mxu``, ``tsar_lut``, no plan, and a planned
      sparse kernel on a layer frozen without pools) runs the planes route,
      ``ops.tsar_matmul``.  That is the reference's semantics
      (``repro/models/layers.py:88-110``: the same layers take its planes
      spelling), not a fallback: the integer math is identical.

    The reference spells the planes route as an inline decode -> int8 dot
    that XLA fuses; eager PyTorch cannot fuse that spelling, so the port
    calls the hand-written kernel.
    """
    k = x.shape[-1]
    m = p["scale"].shape[-1]
    n = x.numel() // k
    lp = plan_runtime.planned(k, m, n)
    if lp is not None:
        kern = lp.kernel
        if kern in registry.SPARSE_KERNELS:
            kern = next((kn for kn in registry.SPARSE_KERNELS
                         if registry.get(kn).supports(p)), kern)
        impl = registry.get(kern)
        if impl.serve_via_registry and impl.supports(p):
            return impl.lower(p, x, lp=lp)
    tw = ternary.TernaryWeights(p["sign"], p["zero"], p["scale"], (k, m))
    return ops.tsar_matmul(x, tw)


def pack_linear(p: dict, lp=None, *, name: str | None = None,
                sparse: bool = False, block_shape: tuple | None = None,
                max_live: int | None = None, s_steps: int | None = None) -> dict:
    """Freeze one 2-D linear layer's latent weights to 2-bit planes, the
    per-channel scale and the measured nonzero-weight ``density``.

    ``lp`` directs the packing: a ``LayerPlan`` or kernel name, or a whole
    ``ModelPlan`` resolved through ``name``.  A layer the plan pins to
    ``dense`` at every bucket keeps fp weights (``{'wd'}``), so the escape
    hatch costs no decode at serve time; any other plan packs planes.

    ``sparse=True`` also emits the padded block-sparse pool
    (``sparse.format.pad_from_ternary``) as ``sp_sign sp_zero sp_map sp_kids
    sp_slots sp_counts`` leaves and the measured live-block fraction
    ``block_density``; ``max_live``/``s_steps`` bound the pool (the full
    block grid by default) so stacked layers share one shape.
    """
    if "w" not in p:
        return p
    if hasattr(lp, "layers"):        # ModelPlan: dense only if every bucket is
        by_bucket = lp.layers.get(name, {}) if name else {}
        kern = "dense" if {e.kernel for e in by_bucket.values()} == {"dense"} else None
    else:
        kern = getattr(lp, "kernel", lp)
    t, scale = ternary.absmean_ternarize(p["w"])
    if kern == "dense":
        return {"wd": (t * scale[..., None, :]).to(p["w"].dtype)}
    tw = ternary.pack(t, scale)
    out = {"sign": tw.sign_plane, "zero": tw.zero_plane, "scale": tw.scale,
           "density": ternary.ternary_density(t)}
    if sparse:
        bk, bm = block_shape or sparse_format.DEFAULT_BLOCK_SHAPE
        pbst = sparse_format.pad_from_ternary(t, scale, bk=bk, bm=bm,
                                              max_live=max_live, s_steps=s_steps)
        out.update({
            "sp_sign": pbst.sign_pool, "sp_zero": pbst.zero_pool,
            "sp_map": pbst.block_map, "sp_kids": pbst.kids,
            "sp_slots": pbst.slots, "sp_counts": pbst.counts,
            "block_density": torch.mean((pbst.occupancy > 0.0).to(torch.float32)),
        })
    return out


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["g"])).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x (..., S, H, Dh), pos (..., S) integer."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = pos[..., None].to(torch.float32) * freqs        # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ---------------------------------------------------------------------------
# Attention (flat token-packed branch)
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n_heads: int, dh: int) -> torch.Tensor:
    return x.reshape(tuple(x.shape[:-1]) + (n_heads, dh))


def _flat_write(c: torch.Tensor, u: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
    """Scatter the step's K or V rows ``u`` (T, Hk, Dh) into a copy of the
    cache view ``c`` (B, Vtok, Hk, Dh) at flat rows ``widx``.  Padding rows
    all land on an explicit dump row appended past the live cells and are
    dropped; real rows have distinct indices."""
    nb, vtok = c.shape[0], c.shape[1]
    flat = torch.cat([c.reshape((nb * vtok,) + tuple(c.shape[2:])),
                      c.new_zeros((1,) + tuple(c.shape[2:]))], dim=0)
    flat.index_copy_(0, widx, u.to(c.dtype))
    return flat[:nb * vtok].reshape(c.shape)


def attention(cfg, p: dict, x: torch.Tensor, *, pos: torch.Tensor, is_global: bool,
              cache: dict, slot: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Flat token-packed attention (the ``flat`` serving policy).

    x (1, T, D) is a ragged batch of T tokens from many slots packed along
    the sequence axis; ``slot``/``pos`` (T,) are per-token coordinates into
    the (B, Vtok) cache view, padding rows carrying the slot sentinel B.
    Each token's K/V row is written to its own (slot, pos) cell and
    attention is segment-masked, so a token sees exactly its own slot's
    causal prefix.  Returns (out (1, T, D), updated {'k','v'} view).
    """
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hk
    b, s, _ = x.shape

    q = _split_heads(linear(p["wq"], x), h, dh)         # (1,T,H,Dh)
    k = _split_heads(linear(p["wk"], x), hk, dh)        # (1,T,Hk,Dh)
    v = _split_heads(linear(p["wv"], x), hk, dh)
    if "qn" in p:
        q = rmsnorm(p["qn"], q, cfg.norm_eps)
        k = rmsnorm(p["kn"], k, cfg.norm_eps)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    nb, vtok = cache["k"].shape[0], cache["k"].shape[1]
    # Explicit flat write index; padding rows go to the dump row nb*vtok.
    dump = torch.full_like(pos, nb * vtok)
    widx = torch.where(slot < nb, slot * vtok + pos, dump)
    ck = _flat_write(cache["k"], k[0], widx)
    cv = _flat_write(cache["v"], v[0], widx)
    new_cache = {"k": ck, "v": cv}

    t = nb * vtok
    kf = ck.reshape((1, t) + tuple(ck.shape[2:]))
    vf = cv.reshape((1, t) + tuple(cv.shape[2:]))
    kidx = torch.arange(t, device=x.device)
    kslot = kidx // vtok
    kpos = kidx % vtok
    valid = (kslot[None, :] == slot[:, None]) & (kpos[None, :] <= pos[:, None])
    if cfg.window_pattern:
        in_win = kpos[None, :] > (pos[:, None] - cfg.window_size)
        valid = valid & (bool(is_global) | in_win)
    # Padding queries (slot == B) match no key: their softmax row is uniform
    # over the finite masked scores -- garbage, but never NaN, never emitted.
    mask = valid[None, None, None, :, :]                # (1,1,1,T,B*Vtok)

    qg = q.reshape(b, s, hk, g, dh)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, kf.to(qg.dtype))
    scores = scores / math.sqrt(dh)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    ctx = torch.einsum("bhgst,bthd->bshgd", probs, vf.to(probs.dtype))
    out = linear(p["wo"], ctx.reshape(b, s, h * dh))
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        return linear(p["w_down"], silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))
    return linear(p["w_down"], F.gelu(linear(p["w_up"], x), approximate="tanh"))
