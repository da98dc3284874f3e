"""Transformer building blocks (port of ``repro/models/layers.py``).

Params are plain dicts of tensors.  Every projection goes through
:func:`linear`, which dispatches on the param dict: ``{'w'}`` = ternary
BitLinear latent weights (``train=True``: the QAT fake-quant forward with
straight-through gradients; ``train=False``: the exact int8 pipeline),
``{'sign','zero','scale'}`` = frozen 2-bit T-SAR planes (the serving path,
through the hand-written kernels and the active execution plan), ``{'wd'}``
= plain dense fp (embeddings, router, frontends, and every weight of a
``cfg.ternary=False`` model).

Attention has the reference's four branches (flat token-packed,
synchronous decode, chunked append, full sequence) and its cross-attention
(``kv_x``, the enc-dec decoder).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import bitlinear, ternary
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.plan import registry
from repro_torch.plan import runtime as plan_runtime
from repro_torch.sparse import format as sparse_format
from repro_torch.utils.act_sharding import constrain, is_dtensor, unshard


# ---------------------------------------------------------------------------
# Init: latent fp32 params in the reference's layout (``init_*`` of
# ``repro/models/layers.py``); the random numbers come from a
# ``torch.Generator`` on the params' device and differ from the reference's.
# ---------------------------------------------------------------------------

def normal(generator: torch.Generator, shape: tuple, std: float,
           dev: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=dev) * std


def init_linear(generator: torch.Generator, k: int, m: int, dev: torch.device,
                ternary_layer: bool = True) -> dict:
    """(k, m) weights, fan-in scaled: BitLinear latent ``{'w'}``, or plain
    dense ``{'wd'}`` for a non-ternary layer."""
    w = normal(generator, (k, m), 1.0 / math.sqrt(k), dev)
    return {"w": w} if ternary_layer else {"wd": w}


def init_rmsnorm(d: int, dev: torch.device) -> dict:
    return {"g": torch.zeros((d,), dtype=torch.float32, device=dev)}


def init_attention(cfg, generator: torch.Generator, dev: torch.device,
                   cross: bool = False) -> dict:
    """Q/K/V/O projections, with qk-norm gains where the config asks for
    them; a ``cross`` block (enc-dec) has none."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tern = cfg.ternary
    p = {"wq": init_linear(generator, d, h * dh, dev, tern),
         "wk": init_linear(generator, d, hk * dh, dev, tern),
         "wv": init_linear(generator, d, hk * dh, dev, tern),
         "wo": init_linear(generator, h * dh, d, dev, tern)}
    if cfg.qk_norm and not cross:
        p["qn"], p["kn"] = init_rmsnorm(dh, dev), init_rmsnorm(dh, dev)
    return p


def init_mlp(cfg, generator: torch.Generator, dev: torch.device) -> dict:
    d, f, tern = cfg.d_model, cfg.d_ff, cfg.ternary
    if cfg.mlp_gated:
        return {"w_gate": init_linear(generator, d, f, dev, tern),
                "w_up": init_linear(generator, d, f, dev, tern),
                "w_down": init_linear(generator, f, d, dev, tern)}
    return {"w_up": init_linear(generator, d, f, dev, tern),
            "w_down": init_linear(generator, f, d, dev, tern)}


# ---------------------------------------------------------------------------
# Linear dispatch
# ---------------------------------------------------------------------------

def linear(p: dict, x: torch.Tensor, train: bool = True) -> torch.Tensor:
    if "wd" in p:
        return x @ p["wd"].to(x.dtype)
    if "w" in p:  # BitLinear latent weights
        if train:
            return bitlinear.apply_train(p, x)
        return bitlinear.apply_eval(p, x)
    if "sign" in p:  # frozen packed planes: decode-in-registers kernel
        return _packed_linear(p, x).to(x.dtype)
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
    with obs_trace.span("proj"):
        if is_dtensor(p["sign"]) or is_dtensor(x):
            return _packed_linear_mesh(p, x)
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


def _packed_linear_mesh(p: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`_packed_linear` with the planes as DTensors on a device mesh
    placed by ``train.sharding.param_specs`` (the counterpart of the
    reference's ``shard_map``): ``tsar_matmul`` runs on each rank's local
    shards (``local_map``).  The data axes keep x's batch sharding and
    gather any FSDP split of the planes (all-gather at use).  On 'model':

    * column-parallel (planes sharded on M): the kernel runs on the local
      column slice of the replicated x; the output is sharded on its last
      dimension;
    * row-parallel (planes sharded on K/8, x gathered or split to match):
      the per-row absmax is all-reduced (MAX) first, so each rank quantizes
      its K slice with the whole row's scale; the kernel runs with unit
      scales, which returns the int32 partial sums exactly as float32
      (|sum| <= 127 K < 2**24); these are all-reduced (SUM, exact integers)
      and scaled ``(S * a_scale) * w_scale``, the kernel's own order.  The
      result is bit-identical to the unsharded call;
    * planes not sharded on 'model' (a spec that ``sanitize_spec`` dropped
      to replicated): the plain unsharded call on each rank.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    sign = p["sign"]
    if not isinstance(sign, DTensor):
        raise ValueError("packed planes must be DTensors when x is one")
    mesh = sign.device_mesh
    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model")
    m = p["scale"].shape[-1]
    kind = "replicated"
    if sign.placements[mi] == Shard(sign.ndim - 1):
        kind = "col"
    elif sign.placements[mi] == Shard(sign.ndim - 2):
        kind = "row"
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    # Data axes: the batch keeps x's sharding (Shard(0) stays, anything
    # else is gathered); the weights are replicated over them.
    xpl = [pl if (i != mi and pl == Shard(0)) else Replicate()
           for i, pl in enumerate(x.placements)]
    rep = [Replicate()] * mesh.ndim
    wpl, spl, opl = list(rep), list(rep), list(xpl)
    if kind == "col":
        wpl[mi], spl[mi], opl[mi] = Shard(sign.ndim - 1), Shard(0), Shard(x.ndim - 1)
    elif kind == "row":
        wpl[mi], xpl[mi] = Shard(sign.ndim - 2), Shard(x.ndim - 1)
    group = mesh.get_group("model") if kind == "row" else None

    def local(xl, s, z, sc):
        if kind != "row":
            tw = ternary.TernaryWeights(s, z, sc, (xl.shape[-1], sc.shape[-1]))
            return ops.tsar_matmul(xl, tw)
        x2 = xl.reshape(-1, xl.shape[-1]).to(torch.float32)
        absmax = torch.amax(torch.abs(x2), dim=-1, keepdim=True)
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        a_q, a_scale = ternary.quantize_activations(x2, absmax=absmax)
        tw = ternary.TernaryWeights(s, z, torch.ones_like(sc), (xl.shape[-1], m))
        acc = ops.tsar_matmul_quantized(a_q, torch.ones_like(a_scale), tw)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        return ((acc * a_scale) * sc).reshape(tuple(xl.shape[:-1]) + (m,))

    fn = local_map(local, out_placements=list(opl),
                   in_placements=(tuple(xpl), tuple(wpl), tuple(wpl), tuple(spl)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(x, sign, p["zero"], p["scale"])


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
    """RMSNorm.  The mean square is summed in float64 and rounded once to
    float32: on the GPU a float32 row reduction's order follows the number
    of rows in the call, which differs per step layout (see
    :func:`attention`); the float64 sums differ far below a float32 ulp."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf.to(torch.float64)), dim=-1,
                     keepdim=True).to(torch.float32)
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
# Attention
# ---------------------------------------------------------------------------

# Query-block size for long sequences: queries are attended block by block
# above it, which bounds the transient (Sq, T) score tile at
# B*H*Q_CHUNK*T elements per layer.
Q_CHUNK = 1024
# Float64 score elements of one pass of the flat branch (1 GiB): a flat step
# scores its T queries against as many slots' key rows at a time as this
# allows, one slot at the least (:func:`_flat_context`).
FLAT_SCORES = 2 ** 27


def split_heads(x: torch.Tensor, n_heads: int, dh: int) -> torch.Tensor:
    """(..., H * Dh) -> (..., H, Dh).  A DTensor whose features are split
    over a mesh axis that does not divide H is gathered on them first: the
    heads could not carry that split (the head-axis chain of
    ``act_sharding.spec_for`` then leaves H replicated on that axis)."""
    if is_dtensor(x) and any(pl.is_shard(x.ndim - 1) and n_heads % x.device_mesh.shape[i]
                             for i, pl in enumerate(x.placements)):
        x = unshard(x, -1)
    return x.reshape(tuple(x.shape[:-1]) + (n_heads, dh))


def _flat_write(c: torch.Tensor, u: torch.Tensor, widx: torch.Tensor) -> torch.Tensor:
    """Scatter the step's K or V rows ``u`` (T, Hk, Dh) into a copy of the
    cache view ``c`` (B, Vtok, Hk, Dh) at flat rows ``widx``.  Padding rows
    all land on an explicit dump row appended past the live cells and are
    dropped; real rows have distinct indices."""
    nb, vtok = c.shape[0], c.shape[1]
    with obs_trace.span("kv.write"):
        flat = torch.cat([c.reshape((nb * vtok,) + tuple(c.shape[2:])),
                          c.new_zeros((1,) + tuple(c.shape[2:]))], dim=0)
        flat.index_copy_(0, widx, u.to(c.dtype))
        return flat[:nb * vtok].reshape(c.shape)


def write_rows(c: torch.Tensor, u: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """A copy of the cache view ``c`` (B, T, Hk, Dh) with each slot's S new
    rows ``u`` (B, S, Hk, Dh) written contiguously from ``start`` (B,).  Like
    the reference's ``dynamic_update_slice``, a start past ``T - S`` is
    clamped so the rows fit."""
    if is_dtensor(c):
        return _write_rows_mesh(c, u, start)
    b, s = u.shape[0], u.shape[1]
    start = start.to(device=c.device, dtype=torch.long).clamp(0, c.shape[1] - s)
    rows = start[:, None] + torch.arange(s, device=c.device)
    out = c.clone()
    out[torch.arange(b, device=c.device)[:, None], rows] = u.to(c.dtype)
    return out


def _write_rows_mesh(c, u: torch.Tensor, start: torch.Tensor):
    """:func:`write_rows` of a cache view that is a DTensor: DTensor has no
    rule for an in-place ``index_put_`` into a batch-sharded tensor, so each
    rank writes its own block (``local_map``), ``start`` split as the
    cache's batch is.  A cache split on its sequence keeps its split (no
    gather): the rows ``u`` come whole along it and each rank writes only
    those whose positions fall in its block (:func:`_write_block`)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = c.device_mesh
    cpl = tuple(c.placements)
    upl = tuple(Replicate() if pl == Shard(1) else pl for pl in cpl)
    spl = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in cpl)
    if not isinstance(start, DTensor):
        start = DTensor.from_local(start.to(device=u.device, dtype=torch.long).expand(c.shape[0]),
                                   mesh, (Replicate(),) * mesh.ndim, run_check=False)
    if upl == cpl:
        fn = write_rows
    else:
        fn = functools.partial(_write_block, offset=_block_start(mesh, cpl, 1, c.shape[1]),
                               total=c.shape[1])
    return local_map(fn, out_placements=list(cpl), in_placements=(cpl, upl, spl),
                     device_mesh=mesh, redistribute_inputs=True)(c, u, start)


def _block_start(mesh, placements: tuple, dim: int, size: int) -> int:
    """The first index along ``dim`` (of ``size``) of this rank's block of
    a DTensor in ``placements``: DTensor splits a dimension sharded on
    several mesh axes in mesh-axis order (``train.sharding.local_shard``)."""
    coord = mesh.get_coordinate()
    first = 0
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            size //= mesh.shape[i]
            first += coord[i] * size
    return first


def _write_block(c: torch.Tensor, u: torch.Tensor, start: torch.Tensor, offset: int,
                 total: int) -> torch.Tensor:
    """:func:`write_rows` into one rank's block ``c`` (B, Tb, Hk, Dh) of a
    cache view split on its sequence, the block holding positions
    ``[offset, offset + Tb)`` of ``total``: ``start`` clamped on the whole
    sequence, and only the rows of ``u`` (B, S, Hk, Dh) in the block
    written (the others land on :func:`_flat_write`'s dump row)."""
    b, s, tb = u.shape[0], u.shape[1], c.shape[1]
    start = start.to(device=c.device, dtype=torch.long).clamp(0, total - s)
    rows = start[:, None] + torch.arange(s, device=c.device) - offset
    slot = torch.arange(b, device=c.device)[:, None]
    widx = torch.where((rows >= 0) & (rows < tb), slot * tb + rows, b * tb)
    return _flat_write(c, u.reshape((b * s,) + tuple(u.shape[2:])), widx.reshape(-1))


def _windowed(cfg, valid: torch.Tensor, kpos: torch.Tensor, qpos: torch.Tensor,
              is_global: bool) -> torch.Tensor:
    """``valid`` narrowed to the sliding window on local layers."""
    if not cfg.window_pattern or is_global:
        return valid
    return valid & (kpos > qpos - cfg.window_size)


def attention(cfg, p: dict, x: torch.Tensor, *, pos: torch.Tensor, is_global: bool,
              kv_x: torch.Tensor | None = None, causal: bool = True,
              cache: dict | None = None, cache_len=None,
              slot: torch.Tensor | None = None, train: bool = True,
              return_kv: bool = False) -> tuple[torch.Tensor, dict | tuple | None]:
    """Self-attention with GQA, RoPE, qk-norm, the attention softcap and
    sliding-window masking on local layers.  x (B, S, D).  With ``kv_x``
    (B, T, D) it is cross-attention: K and V are projected from ``kv_x``,
    neither side is rotated and nothing is masked (no cache; the enc-dec
    decoder passes it).  The branch follows the cache arguments, as in the
    reference:

    * ``cache`` and ``slot`` (flat token-packed, the ``flat`` serving
      policy): x (1, T, D) is a ragged batch of T tokens from many slots;
      ``slot``/``pos`` (T,) are per-token coordinates into the (B, Vtok)
      cache view, padding rows carrying the slot sentinel B.  Each token's
      K/V row goes to its own (slot, pos) cell and the token attends over
      its own slot's row of the view, causally: it sees exactly its slot's
      prefix;
    * ``cache`` and a scalar ``cache_len`` (synchronous decode): the new
      rows are written at ``cache_len`` in every slot and attend over the
      prefix up to it;
    * ``cache`` and a (B,) ``cache_len`` (chunked append, the ``chunked``
      policy): each slot's S rows are written from its own offset, and
      ``pos`` (B, S) or (S,) carries absolute query positions; the mask is
      causal in absolute position, so a first chunk may start past a forked
      prefix and rows beyond a slot's live length are never attended;
    * no cache (full sequence): causal (or unmasked) over the S tokens;
      ``return_kv`` returns their (k, v) for a prefill to store.

    Returns (out (B, S, D), the updated {'k','v'} view), or (out, (k, v))
    with ``return_kv``; the view is None without a cache.
    """
    with obs_trace.span("attn"):
        h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        b, s, _ = x.shape

        src = x if kv_x is None else kv_x
        q = split_heads(linear(p["wq"], x, train), h, dh)         # (B,S,H,Dh)
        k = split_heads(linear(p["wk"], src, train), hk, dh)      # (B,S|T,Hk,Dh)
        v = split_heads(linear(p["wv"], src, train), hk, dh)
        if "qn" in p:
            q = rmsnorm(p["qn"], q, cfg.norm_eps)
            k = rmsnorm(p["kn"], k, cfg.norm_eps)
        if kv_x is None:                                    # no RoPE on cross-attention
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        # Pin head-sharded layouts on a mesh (identity without one).
        q = constrain(q, "attn_q")
        k = constrain(k, "attn_kv")
        v = constrain(v, "attn_kv")

        new_cache = ctx = None
        if cache is not None and slot is not None:
            nb, vtok = cache["k"].shape[0], cache["k"].shape[1]
            # Explicit flat write index; padding rows go to the dump row nb*vtok.
            dump = torch.full_like(pos, nb * vtok)
            widx = torch.where(slot < nb, slot * vtok + pos, dump)
            ck = _flat_write(cache["k"], k[0], widx)
            cv = _flat_write(cache["v"], v[0], widx)
            new_cache = {"k": ck, "v": cv}
            ctx = _flat_context(cfg, q, ck, cv, slot, pos, is_global, x.dtype)
        elif cache is not None and torch.as_tensor(cache_len).ndim == 0:
            n_past = int(cache_len)
            start = torch.full((b,), n_past, dtype=torch.long)
            ck = write_rows(cache["k"], k, start)
            cv = write_rows(cache["v"], v, start)
            new_cache = {"k": ck, "v": cv}
            k, v = ck, cv
            kpos = torch.arange(k.shape[1], device=x.device)
            valid = _windowed(cfg, kpos <= n_past, kpos, n_past, is_global)
            mask = valid[None, None, None, None, :]             # (1,1,1,1,T)
        elif cache is not None:
            ck = write_rows(cache["k"], k, cache_len)
            cv = write_rows(cache["v"], v, cache_len)
            new_cache = {"k": ck, "v": cv}
            k, v = ck, cv
            kpos = torch.arange(k.shape[1], device=x.device)[None, None, :]
            qabs = (pos if pos.ndim == 2 else pos[None, :].expand(b, s))[:, :, None]
            valid = _windowed(cfg, kpos <= qabs, kpos, qabs, is_global)   # (B,S,T)
            mask = valid[:, None, None, :, :]                   # (B,1,1,S,T)
        elif causal and kv_x is None:
            qpos, kpos = pos[:, None], pos[None, :]
            mask = _windowed(cfg, kpos <= qpos, kpos, qpos, is_global)[None, None, None]
        else:
            mask = None

        # Scores, softmax and the weighted sum run in float64 and the context is
        # rounded once to x's dtype.  The policies and the prefix cache batch a
        # token's query with different neighbours (T flat tokens, B x C chunk
        # rows, a whole prompt over its own keys), and on the GPU the float32
        # batched matmuls pick their reduction order by those shapes: a token's
        # context then moves by an ulp between layouts, enough to move an int8
        # activation code downstream and, over many layers, a greedy token.  The
        # float64 results differ far below a float32 ulp, so rounding them once
        # gives every layout the same bits with high probability (not
        # certainty: a float64 value within its own error of a float32 rounding
        # boundary can still round either way).
        if ctx is None:
            ctx = context(cfg, q, k, v, mask, x.dtype)
        out = linear(p["wo"], ctx.reshape(x.shape[0], x.shape[1], h * dh), train)
        if return_kv:
            return out, (k, v)
        return out, new_cache


def _flat_context(cfg, q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  slot: torch.Tensor, pos: torch.Tensor, is_global: bool,
                  dtype: torch.dtype) -> torch.Tensor:
    """The flat branch's context (1, T, Hk, G, Dh) of the T packed queries
    q (1, T, H, Dh) over the updated view ck, cv (B, Vtok, Hk, Dh), in the
    reference's layout: a group of slots' rows is one key axis (a view of
    the cache, no copy) under the segment mask ``kslot == slot``, causal in
    ``pos`` and windowed on local layers, so a token sees exactly its own
    slot's prefix.  The reference scores every query against all B * Vtok
    keys at once; here the slots go in as few groups as keep a pass's
    scores within ``FLAT_SCORES`` (one group, the reference's pass, on a
    decode step; smaller groups on a long prefill), and each token keeps
    its own group's row (``torch.where``), its rows from other groups being
    masked everywhere.  Padding tokens (slot == B) keep the first group's
    row: uniform over finite masked scores -- garbage, never emitted."""
    nb, vtok = ck.shape[0], ck.shape[1]
    slot_scores = q.shape[1] * q.shape[2] * vtok          # T x H x Vtok per slot
    passes = max(1, min(nb, -(-nb * slot_scores // FLAT_SCORES)))
    per = -(-nb // passes)                                # slots per pass
    kpos = torch.arange(vtok, device=q.device)
    qpos = pos[:, None, None]
    ctx = None
    for g0 in range(0, nb, per):
        n = min(per, nb - g0)
        kslot = torch.arange(g0, g0 + n, device=q.device)[None, :, None]
        valid = (slot[:, None, None] == kslot) & (kpos <= qpos)      # (T, n, Vtok)
        valid = _windowed(cfg, valid, kpos, qpos, is_global)
        mask = valid.reshape(1, 1, 1, -1, n * vtok)                   # (1,1,1,T,n*Vtok)
        k = ck[g0:g0 + n].reshape((1, n * vtok) + tuple(ck.shape[2:]))
        v = cv[g0:g0 + n].reshape((1, n * vtok) + tuple(cv.shape[2:]))
        part = _context(cfg, q, k, v, mask, dtype)
        if ctx is None:
            ctx = part
        else:
            mine = (slot >= g0) & (slot < g0 + n)
            ctx = torch.where(mine[None, :, None, None, None], part, ctx)
    return ctx


def context(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """The attention context of q (B, S, H, Dh) against k, v (B, T, Hk, Dh)
    under ``mask``, in ``dtype``, to be flattened to (B, S, H * Dh): on a
    device mesh per rank (:func:`_context_mesh`, pinned to the query
    layout), else :func:`_context`."""
    if is_dtensor(q):
        return constrain(_context_mesh(cfg, q, k, v, mask, dtype), "attn_q")
    return _context(cfg, q, k, v, mask, dtype)


def _context(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: torch.Tensor | None, dtype: torch.dtype, groups: tuple = ()) -> torch.Tensor:
    """The attention context (B, S, Hk, G, Dh) of q (B, S, H, Dh) against
    k, v (B, T, Hk, Dh) under ``mask``; with ``groups``, k, v and the mask
    are this rank's block of keys split on their sequence over those
    process groups (:func:`attend_split`)."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, s, hk, h // hk, dh)
    k64, v64 = k.to(torch.float64), v.to(torch.float64)

    def core(qb, mb):
        if groups:
            return attend_split(cfg, qb, k64, v64, mb, dtype, groups)
        return attend_core(cfg, qb, k64, v64, mb, dtype)

    # Long sequences: one query block at a time, each against its full key
    # row (exact), so the (Sq, T) score tile stays bounded.
    if s > Q_CHUNK and s % Q_CHUNK == 0 and mask is not None:
        return torch.cat([core(qg[:, i:i + Q_CHUNK], mask[..., i:i + Q_CHUNK, :])
                          for i in range(0, s, Q_CHUNK)], dim=1)
    return core(qg, mask)


def _context_mesh(cfg, q, k, v, mask, dtype):
    """:func:`_context` of DTensors, per rank on its own block
    (``local_map``): batch rows split over the data axes; on an axis that
    splits the keys' sequence (a cache split on it, the queries not) each
    rank attends over its own block of positions and the partial softmax
    is combined across the axis (:func:`attend_split`, the split-KV
    scheme); heads over 'model' where the KV heads divide (a query head's
    group stays with its KV head); where the query heads divide the axis
    and the KV heads do not but divide its size (qwen3-32b: 64 and 8 heads
    on 16 ranks), the queries keep their head split and each rank takes
    from whole keys the one KV head its block of queries belongs to
    (:func:`_kv_head_of`); else queries split on their sequence axis
    against whole keys.  The context comes back (B, S, H, Dh) in those
    placements.  DTensor's einsum strategies are not needed (some versions
    refuse a head-sharded score einsum)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    b, s, t = q.shape[0], q.shape[1], k.shape[1]
    h, hk = q.shape[2], k.shape[2]
    qpl, kpl, mpl, split_kv, kv_head = [], [], [], [], None
    if mask is not None and not is_dtensor(mask):
        mask = DTensor.from_local(mask, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    for i, pl in enumerate(q.placements):
        kp = k.placements[i] if is_dtensor(k) else Replicate()
        if pl == Shard(0):
            qpl.append(Shard(0))
            kpl.append(Shard(0))
            mpl.append(Shard(0) if mask is not None and mask.shape[0] == b else Replicate())
        elif kp == Shard(1) and pl != Shard(1):
            split_kv.append(i)
            qpl.append(Replicate())
            kpl.append(Shard(1))
            mpl.append(Shard(mask.ndim - 1) if mask is not None and mask.shape[-1] == t
                       else Replicate())
        elif pl == Shard(2) and hk % mesh.shape[i] == 0:
            qpl.append(Shard(2))
            kpl.append(Shard(2))
            mpl.append(Replicate())
        elif (pl == Shard(2) and kv_head is None and h % mesh.shape[i] == 0
              and mesh.shape[i] % hk == 0):
            kv_head = _kv_head_of(mesh, i, hk)
            qpl.append(Shard(2))
            kpl.append(Replicate())
            mpl.append(Replicate())
        elif pl == Shard(1) and s % mesh.shape[i] == 0:
            qpl.append(Shard(1))
            kpl.append(Replicate())
            mpl.append(Shard(mask.ndim - 2) if mask is not None and mask.shape[-2] == s
                       else Replicate())
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
            mpl.append(Replicate())
    groups = tuple(mesh.get_group(i) for i in split_kv)

    def local(ql, kl, vl, ml):
        if kv_head is not None:
            kl, vl = kl[:, :, kv_head:kv_head + 1], vl[:, :, kv_head:kv_head + 1]
        return _context(cfg, ql, kl, vl, ml, dtype, groups).reshape(ql.shape)

    fn = local_map(local, out_placements=list(qpl),
                   in_placements=(tuple(qpl), tuple(kpl), tuple(kpl),
                                  None if mask is None else tuple(mpl)),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(q, k, v, mask)


def _kv_head_of(mesh, i: int, hk: int) -> int:
    """The KV head of this rank's block of query heads on mesh axis ``i``,
    whose size m is a multiple of the ``hk`` KV heads: the H query heads
    split into m contiguous blocks, and KV head j serves query heads
    [j * H / hk, (j + 1) * H / hk), so blocks r with r // (m / hk) == j."""
    return mesh.get_local_rank(i) // (mesh.shape[i] // hk)


def _scores(cfg, qg: torch.Tensor, k: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Float64 scores (B, Hk, G, Sq, T) of qg against k: scaled, softcapped
    and masked (a masked score is float64's lowest)."""
    scores = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float64),
                          k.to(torch.float64)) / math.sqrt(qg.shape[-1])
    scores = softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    return scores


def attend_core(cfg, qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """Scores, softcap, mask, softmax and the weighted sum of one query
    block qg (B, Sq, Hk, G, Dh) against k, v (B, T, Hk, Dh), in float64;
    the context (B, Sq, Hk, G, Dh) is rounded once to ``dtype`` (see
    :func:`attention` for why)."""
    probs = torch.softmax(_scores(cfg, qg, k, mask), dim=-1)
    return torch.einsum("bhgst,bthd->bshgd", probs, v.to(torch.float64)).to(dtype)


def attend_split(cfg, qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor | None, dtype: torch.dtype, groups: tuple) -> torch.Tensor:
    """:func:`attend_core` with the keys split on their sequence over the
    ranks of ``groups`` (flash-decoding's split-KV): k, v and the mask are
    this rank's block of positions.  The scores' row max is all-reduced
    (MAX), each rank sums ``exp(s - max)`` and its weighted values over its
    block in float64, the two sums are all-reduced (SUM) and their ratio is
    rounded once to ``dtype``.  A block whose positions are all masked
    gives exactly zero weight; a row masked everywhere is uniform over
    every position, as the unsharded softmax makes it."""
    scores = _scores(cfg, qg, k, mask)
    top = torch.amax(scores, dim=-1, keepdim=True)
    for group in groups:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(scores - top)
    den = torch.sum(e, dim=-1, keepdim=True)                   # (B,Hk,G,Sq,1)
    num = torch.einsum("bhgst,bthd->bhgsd", e, v.to(torch.float64))
    for group in groups:
        dist.all_reduce(den, group=group)
        dist.all_reduce(num, group=group)
    return (num / den).permute(0, 3, 1, 2, 4).to(dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(p: dict, x: torch.Tensor, train: bool = True) -> torch.Tensor:
    if "w_gate" in p:
        return linear(p["w_down"], silu(linear(p["w_gate"], x, train))
                      * linear(p["w_up"], x, train), train)
    return linear(p["w_down"], F.gelu(linear(p["w_up"], x, train), approximate="tanh"),
                  train)
