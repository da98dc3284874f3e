"""Plain PyTorch forward pass of a dense ternary decoder (BitNet b1.58
style, the projection math of T-SAR), the reference that decides a cell's
``correct``.

One full forward pass over each sequence, layer by layer, with no cache,
no batching across sequences and no kernel: it regenerates each layer's
latent weights from ``(seed, layer)`` with the benchmark's generator
(``h100bench.weights``), ternarizes them itself and frees them before the
next layer, so a 62-layer model at full width fits beside nothing else.
It imports nothing of the program.

The mathematics (per layer): ``x += Wo(attn(rope(Wq h), rope(Wk h), Wv h))``
with ``h = rmsnorm(x)``, then ``x += Wdown(silu(Wgate h2) * Wup h2)`` with
``h2 = rmsnorm(x)``; every projection quantizes its input per token to int8
by absmax and multiplies the ternary weights (absmean threshold, one
least-squares scale per output channel), ``y = (q @ t) * a_scale * w_scale``;
the embedding is scaled by sqrt(d); rmsnorm multiplies by ``1 + g``; the
head is the untied float32 matrix after a final rmsnorm.  Attention is
causal with grouped KV heads and rotate-half RoPE.

Precision: float32 with TF32 off, except that the attention's scores,
softmax and weighted sum, and rmsnorm's mean square, run in float64 and are
rounded once to float32.  The integer products ``q @ t`` are exact in
float32 (|sum| <= 127 K < 2**24), and exact in TF32 too: every operand is
an integer of at most 7 bits, which TF32's 11-bit significand holds, and
every product and partial sum an integer below 2**24.  So they run with
TF32 allowed, on the card's tensor cores, and give the same bits.
"""
from __future__ import annotations

import math

import torch

from h100bench import weights

# Rows of one query block of the attention (bounds its float64 scores).
Q_BLOCK = 512
# Rows of one block of the projections (bounds their float32 outputs).
ROW_BLOCK = 4096


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ternarize(w: torch.Tensor, eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(t in {-1, 0, 1} as float32 (K, M), per-output-channel scale (M,))."""
    gamma = torch.mean(torch.abs(w), dim=(-2, -1), keepdim=True) + eps
    t = torch.clamp(torch.round(w / gamma), -1, 1)
    scale = torch.sum(w * t, dim=-2) / (torch.sum(t * t, dim=-2) + eps)
    return t, scale.to(torch.float32)


def bitlinear(x: torch.Tensor, t: torch.Tensor, w_scale: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Per-token int8 absmax quantization, the exact integer product with
    the ternary weights, then both scales."""
    out = []
    for i in range(0, x.shape[0], ROW_BLOCK):
        xb = x[i:i + ROW_BLOCK]
        absmax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
        a_scale = (absmax / 127.0 + eps).to(torch.float32)
        q = torch.clamp(torch.round(xb / a_scale), -127, 127)
        out.append(_integer_product(q, t) * a_scale * w_scale)
    return torch.cat(out)


def _integer_product(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``q @ t`` of integer-valued float32 operands, TF32 allowed (exact:
    see the module's docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return q @ t
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x.to(torch.float64)), dim=-1, keepdim=True).to(torch.float32)
    return x * torch.rsqrt(var + eps) * (1.0 + g)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, Dh), pos (S,): rotate-half RoPE."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = pos[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, Dh), k, v (S, Hk, Dh) ->
    (S, H * Dh)."""
    s, h, dh = q.shape
    hk = k.shape[1]
    k64, v64 = k.to(torch.float64), v.to(torch.float64)
    kpos = torch.arange(s, device=q.device)
    out = []
    for i in range(0, s, Q_BLOCK):
        qb = q[i:i + Q_BLOCK].reshape(-1, hk, h // hk, dh).to(torch.float64)
        scores = torch.einsum("shgd,thd->hgst", qb, k64) / math.sqrt(dh)
        qpos = torch.arange(i, i + qb.shape[0], device=q.device)
        scores = scores.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out.append(torch.einsum("hgst,thd->shgd", probs, v64).to(torch.float32))
    return torch.cat(out).reshape(s, h * dh)


def served_gaps(c: dict, seed: int, seqs: list, device) -> list[torch.Tensor]:
    """For each ``(prompt, served)`` pair, the gap at every served token:
    the reference's best logit minus its logit of the token served there
    (0 where the served token is the reference's first choice).  The
    sequence run is the prompt and every served token but the last; the
    i-th served token is scored at position ``len(prompt) - 1 + i``."""
    _no_tf32()
    n = weights.dims(c)
    d, h, hk, dh, eps = n["d"], n["h"], n["hk"], n["dh"], n["eps"]
    toks = [torch.as_tensor(list(p) + list(o[:-1]), dtype=torch.long, device=device)
            for p, o in seqs]
    lens = [len(t) for t in toks]
    hw = weights.head(c, seed, device)
    x = hw["embed"][torch.cat(toks)] * math.sqrt(d)
    pos = torch.cat([torch.arange(s, device=device) for s in lens])
    bounds = [0]
    for s in lens:
        bounds.append(bounds[-1] + s)
    for i in range(n["layers"]):
        w = weights.layer(c, seed, i, device)
        tw = {name: ternarize(w[name]) for name, _, _ in weights.projections(c)}
        g1, g2 = w["ln1"].clone(), w["ln2"].clone()
        del w
        hid = rmsnorm(x, g1, eps)
        q = rope(bitlinear(hid, *tw["wq"]).view(-1, h, dh), pos, n["theta"])
        k = rope(bitlinear(hid, *tw["wk"]).view(-1, hk, dh), pos, n["theta"])
        v = bitlinear(hid, *tw["wv"]).view(-1, hk, dh)
        ctx = torch.cat([attention(q[a:b], k[a:b], v[a:b])
                         for a, b in zip(bounds, bounds[1:])])
        x = x + bitlinear(ctx, *tw["wo"])
        hid = rmsnorm(x, g2, eps)
        gate = bitlinear(hid, *tw["w_gate"])
        x = x + bitlinear(gate * torch.sigmoid(gate) * bitlinear(hid, *tw["w_up"]),
                          *tw["w_down"])
        del tw
    out = []
    for (p, o), a in zip(seqs, bounds):
        rows = x[a + len(p) - 1:a + len(p) - 1 + len(o)]
        logits = rmsnorm(rows, hw["ln_f"], eps) @ hw["lm_head"][:, :n["vocab"]]
        served = torch.as_tensor(list(o), dtype=torch.long, device=device)
        out.append(logits.max(dim=-1).values - logits.gather(1, served[:, None])[:, 0])
    return out
