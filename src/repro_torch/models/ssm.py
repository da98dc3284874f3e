"""Mamba-2 (SSD, state-space duality) block, chunked (port of
``repro/models/ssm.py``).

The exact chunked SSD algorithm of arXiv:2405.21060: within-chunk terms are
dense einsums, the across-chunk recurrence is a short loop over chunk states
(the reference's ``lax.scan``).  Decode is the O(1)-per-token recurrent step
with a rolling depthwise-conv state.  Everything runs in float32.

The in/out projections are ternary BitLinear (``layers.linear``: frozen
planes run ``tsar_matmul``); ``A_log``, ``D``, ``dt_bias`` and the conv
weights stay fp, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.utils.act_sharding import is_dtensor


def _dims(cfg) -> tuple[int, int, int, int]:
    di = cfg.d_inner
    n = cfg.ssm_state
    nh = cfg.ssm_heads
    conv_dim = di + 2 * n          # conv over (x, B, C), ngroups = 1
    return di, n, nh, conv_dim


def init_ssm(cfg, generator: torch.Generator, dev: torch.device) -> dict:
    d = cfg.d_model
    di, n, nh, conv_dim = _dims(cfg)
    # in_proj emits [z (di), x (di), B (n), C (n), dt (nh)]
    d_in = 2 * di + 2 * n + nh
    return {
        "in_proj": layers.init_linear(generator, d, d_in, dev, cfg.ternary),
        "out_proj": layers.init_linear(generator, di, d, dev, cfg.ternary),
        "conv_w": layers.normal(generator, (cfg.ssm_conv_width, conv_dim), 0.2, dev),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        # softplus^-1(0.01)
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01, dtype=torch.float32,
                                                    device=dev))),
        "norm": layers.init_rmsnorm(di, dev),
    }


def _split_in(cfg, zxbcdt: torch.Tensor) -> tuple[torch.Tensor, ...]:
    di, n, _, _ = _dims(cfg)
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    bs = zxbcdt[..., 2 * di:2 * di + n]
    cs = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, xs, bs, cs, dt


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) lower-triangular cumulative segment sums:
    out[i, j] = sum_{j < t <= i} x[t], -inf above the diagonal."""
    ln = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(ln, device=x.device)
    tri = i[:, None] >= i[None, :]
    return torch.where(tri, diff, -torch.inf)


def ssd_chunked(xd: torch.Tensor, a_dt: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xd   (B, S, H, P)  inputs pre-multiplied by dt
    a_dt (B, S, H)     log-decay per step (= dt * A, negative)
    bmat (B, S, N), cmat (B, S, N)  shared across heads (ngroups=1)
    Returns (y (B,S,H,P), final_state (B,H,P,N)).

    ``S`` must be a multiple of ``chunk``, as the reference asserts: a
    whole prefill of a prompt longer than ``ssm_chunk`` and not a multiple
    of it fails in both packages.
    """
    b, s, h, p = xd.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc = s // chunk

    xc = xd.reshape(b, nc, chunk, h, p)
    ac = a_dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    a_cum = torch.cumsum(ac, dim=2)                                # (B,C,L,H)
    # Intra-chunk (diagonal) term: attention-like dense products.
    lmat = torch.exp(_segsum(torch.movedim(ac, -1, 2)))            # (B,C,H,L,L)
    scores = torch.einsum("bcln,bcsn->bcls", cc, bc)               # (B,C,L,S)
    y_diag = torch.einsum("bcls,bchls,bcshp->bclhp", scores, lmat, xc)

    # Chunk-final states: state_c = sum_l B_l x_l * exp(Acum_last - Acum_l)
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)          # (B,C,L,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", bc, decay_states, xc)

    # Inter-chunk recurrence over the nc chunks; each chunk reads the state
    # entering it.
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                    # (B,C,H)
    carry = (torch.zeros((b, h, p, n), dtype=xd.dtype, device=xd.device)
             if init_state is None else init_state)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                         # (B,C,H,P,N)

    # Off-diagonal contribution from the state entering each chunk.
    state_decay = torch.exp(a_cum)                                 # (B,C,L,H)
    y_off = torch.einsum("bcln,bclh,bchpn->bclhp", cc, state_decay, prev_states)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, carry


def ssm_forward(cfg, p: dict, u: torch.Tensor, train: bool = True, *,
                initial_state: torch.Tensor | None = None,
                initial_conv: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  u (B, S, D) -> (y (B, S, D), final SSD state
    (B, H, P, N)).

    ``initial_state`` (B, H, P, N) seeds the SSD recurrence and
    ``initial_conv`` (B, W-1, conv_dim) seeds the depthwise-conv window with
    the pre-activation xBC tail of the preceding segment (the layout of the
    decode cache's ``conv`` leaf).  With both supplied, running a sequence
    in segments equals the unsegmented call.
    """
    zxbcdt = layers.linear(p["in_proj"], u, train)
    y, final = _mixer(cfg, _forward_core, p, (zxbcdt, initial_state, initial_conv), 2)
    return layers.linear(p["out_proj"], y, train), final


def _forward_core(cfg, zxbcdt, initial_state, initial_conv, conv_w, conv_b, dt_bias, a_log,
                  d_skip, norm_g):
    """:func:`ssm_forward` between the projections: the in_proj output
    (B, S, M) -> (the out_proj input (B, S, di), the final state)."""
    b, s, _ = zxbcdt.shape
    di, n, nh, _ = _dims(cfg)
    hd = cfg.ssm_head_dim

    z, xs, bs, cs, dt = _split_in(cfg, zxbcdt)
    xbc = torch.cat([xs, bs, cs], dim=-1)                          # (B,S,conv_dim)
    xbc = layers.silu(_causal_conv(xbc, conv_w, conv_b, init=initial_conv))
    xs, bs, cs = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = F.softplus(dt + dt_bias)                                  # (B,S,H)
    a = -torch.exp(a_log)                                          # (H,) negative
    xh = xs.reshape(b, s, nh, hd)
    xd = xh * dt[..., None]
    y, final = ssd_chunked(xd, dt * a, bs, cs, min(cfg.ssm_chunk, s),
                           init_state=initial_state)
    y = y + xh * d_skip[None, None, :, None]
    y = y.reshape(b, s, di)
    return layers.rmsnorm({"g": norm_g}, y * layers.silu(z), cfg.norm_eps), final


def _mixer(cfg, core, p: dict, batch: tuple, n_out: int):
    """``core(cfg, *batch, conv_w, conv_b, dt_bias, A_log, D, norm g)``, of
    ``n_out`` outputs.

    ``batch`` holds the in_proj output first, then caches (or None), each
    with the batch leading.  On a device mesh (the in_proj output a
    DTensor) the core runs per rank (``local_map``) on its rows of the
    batch, split over the data axes as the in_proj output's are, with every
    feature and the fp params whole: the scan's heads do not split over
    'model' with the (x, B, C) channels they share, and DTensor's rules
    for the scan's views and einsums differ between torch versions.  Its
    outputs come back in the same placements."""
    params = (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"], p["norm"]["g"])
    x = batch[0]
    if not is_dtensor(x):
        return core(cfg, *batch, *params)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rows = tuple(pl if name != "model" and pl == Shard(0) else Replicate()
                 for name, pl in zip(mesh.mesh_dim_names, x.placements))
    whole = (Replicate(),) * mesh.ndim
    fn = local_map(lambda *a: core(cfg, *a), out_placements=(list(rows),) * n_out,
                   in_placements=tuple(None if t is None else rows for t in batch)
                   + (whole,) * len(params), device_mesh=mesh, redistribute_inputs=True)
    return fn(*batch, *params)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 init: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d.  x (B,S,C), w (W,C).  ``init`` (B,W-1,C)
    replaces the zero left-padding with the previous segment's tail."""
    width = w.shape[0]
    if init is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        if init.shape[1] != width - 1:
            # A wrong-length tail would silently shift every conv window.
            raise ValueError(
                f"initial_conv carries {init.shape[1]} positions, need "
                f"conv_width-1 = {width - 1}")
        xp = torch.cat([init.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    return out + bias


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device="cuda") -> dict:
    _, n, nh, conv_dim = _dims(cfg)
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, nh, cfg.ssm_head_dim, n), dtype=dtype, device=device),
    }


def ssm_decode_step(cfg, p: dict, u: torch.Tensor, cache: dict,
                    train: bool = False) -> tuple[torch.Tensor, dict]:
    """Single-token step.  u (B, 1, D) -> (y (B, 1, D), new {'conv','state'})."""
    zxbcdt = layers.linear(p["in_proj"], u[:, 0, :], train)
    y, conv, state = _mixer(cfg, _decode_core, p, (zxbcdt, cache["conv"], cache["state"]), 3)
    out = layers.linear(p["out_proj"], y, train)[:, None, :]
    return out, {"conv": conv, "state": state}


def _decode_core(cfg, zxbcdt, conv_cache, state_cache, conv_w, conv_b, dt_bias, a_log,
                 d_skip, norm_g):
    """:func:`ssm_decode_step` between the projections: the in_proj output
    (B, M) and the caches -> (the out_proj input (B, di), the new conv and
    state caches)."""
    b = zxbcdt.shape[0]
    di, n, nh, _ = _dims(cfg)
    hd = cfg.ssm_head_dim

    z, xs, bs, cs, dt = _split_in(cfg, zxbcdt)
    xbc = torch.cat([xs, bs, cs], dim=-1)                          # (B,conv_dim)

    # Rolling conv state: window = [conv_state ; x_t]
    win = torch.cat([conv_cache, xbc[:, None, :]], dim=1)          # (B,W,C)
    conv_out = torch.sum(win * conv_w[None, :, :], dim=1) + conv_b
    xbc = layers.silu(conv_out)
    xs, bs, cs = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = F.softplus(dt + dt_bias)                                  # (B,H)
    a = torch.exp(dt * (-torch.exp(a_log)))                        # (B,H) decay
    xh = xs.reshape(b, nh, hd)
    state = state_cache * a[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", bs, xh * dt[..., None])
    y = torch.einsum("bn,bhpn->bhp", cs, state) + xh * d_skip[None, :, None]
    y = y.reshape(b, di)
    return layers.rmsnorm({"g": norm_g}, y * layers.silu(z), cfg.norm_eps), win[:, 1:, :], state
