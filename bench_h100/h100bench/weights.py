"""The latent weights of a cell, made on the device from ``--seed``.

Both sides are handed the same numbers: the program's set-up freezes them
(``serving.freeze_params``), the plain reference ternarizes them itself.
Each layer is one ``torch.randn`` call on a ``torch.Generator`` seeded from
``(seed, layer)``, split into the projections and the two norm gains, so a
layer can be made again alone (the reference runs layer by layer, and a
33B model's latent weights, 132 GB in float32, exist only one layer at a
time).  The distributions are the port's initialisation: a
projection N(0, 1/K), the embedding N(0, 0.02^2), the untied head N(0,
1/d); the norm gains, zero at initialisation, are drawn N(0, 0.1^2) here so
that a fault in applying them shows.
"""
from __future__ import annotations

import hashlib
import math

import torch

GAIN_STD = 0.1


def dims(c: dict) -> dict:
    """The sizes of a configuration file (Hugging Face key names)."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    return {"d": d, "h": h, "hk": c["num_key_value_heads"],
            "dh": c.get("head_dim") or d // h, "f": c["intermediate_size"],
            "vocab": c["vocab_size"], "layers": c["num_hidden_layers"],
            "theta": float(c["rope_theta"]), "eps": float(c["rms_norm_eps"])}


def padded_vocab(vocab: int) -> int:
    """Rows of the embedding table and columns of the head in the port's
    layout: the vocabulary rounded up to a multiple of 2048 (16 below
    2048).  The padding is never read: tokens are drawn below ``vocab``
    and both sides score the first ``vocab`` columns only."""
    mult = 2048 if vocab > 2048 else 16
    return -(-vocab // mult) * mult


def projections(c: dict) -> list[tuple[str, int, int]]:
    """(name, K, M) of one layer's seven ternary projections."""
    n = dims(c)
    d, qd, kvd, f = n["d"], n["h"] * n["dh"], n["hk"] * n["dh"], n["f"]
    return [("wq", d, qd), ("wk", d, kvd), ("wv", d, kvd), ("wo", qd, d),
            ("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]


def seed_for(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run's seed (any integer) and tags."""
    text = ":".join(str(t) for t in (seed,) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def _generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_for(seed, *tags))


def layer(c: dict, seed: int, i: int, device) -> dict[str, torch.Tensor]:
    """Layer ``i``'s latent weights: the seven (K, M) projections and the
    gains ``ln1``, ``ln2``, views into one float32 buffer on ``device``."""
    d = dims(c)["d"]
    shapes = projections(c)
    total = sum(k * m for _, k, m in shapes) + 2 * d
    buf = torch.randn(total, generator=_generator(device, seed, "layer", i),
                      dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, k, m in shapes:
        out[name] = buf[at:at + k * m].view(k, m).mul_(1.0 / math.sqrt(k))
        at += k * m
    out["ln1"] = buf[at:at + d].mul_(GAIN_STD)
    out["ln2"] = buf[at + d:at + 2 * d].mul_(GAIN_STD)
    return out


def head(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The embedding (Vp, d), the final norm's gain (d,) and the untied
    head (d, Vp), Vp = :func:`padded_vocab`."""
    n = dims(c)
    d, vp = n["d"], padded_vocab(n["vocab"])
    buf = torch.randn(2 * vp * d + d, generator=_generator(device, seed, "head"),
                      dtype=torch.float32, device=device)
    return {"embed": buf[:vp * d].view(vp, d).mul_(0.02),
            "lm_head": buf[vp * d:2 * vp * d].view(d, vp).mul_(1.0 / math.sqrt(d)),
            "ln_f": buf[2 * vp * d:].mul_(GAIN_STD)}
