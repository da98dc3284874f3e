"""Density profiling of a packed model (port of ``repro/sparse/stats.py``).

``profile_params`` walks a params tree (frozen packed dicts ``{'sign',
'zero','scale',...}`` or latent ``{'w'}`` dicts, ternarized on the fly) and
reports, per BitLinear layer, the nonzero-weight density, the block
occupancy histogram and the live-block fraction at a (bk, bm) tiling.  The
planes are decoded and counted on the tensors' own device, one stacked
slice at a time; only the small (kb, mb) occupancy grids come to the host
for the histogram.  The serving engine calls it once at init.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ternary
from repro_torch.sparse import format as sparse_format


def weight_density(t: torch.Tensor) -> float:
    """Nonzero fraction of a dense ternary matrix (any leading batch dims)."""
    return int(torch.count_nonzero(t)) / max(t.numel(), 1)


def block_occupancy(t: torch.Tensor, bk: int = sparse_format.DEFAULT_BK,
                    bm: int = sparse_format.DEFAULT_BM) -> torch.Tensor:
    """Per-block nonzero fraction of a ternary (K, M) matrix -> (kb, mb) f32
    on ``t``'s device.  Ragged edges are zero-padded (padding counts as
    zeros)."""
    k, m = t.shape
    kb, mb = -(-k // bk), -(-m // bm)
    tp = torch.nn.functional.pad(t.to(torch.int8), (0, mb * bm - m, 0, kb * bk - k))
    blocks = tp.reshape(kb, bk, mb, bm)
    return torch.count_nonzero(blocks, dim=(1, 3)).to(torch.float32) / (bk * bm)


def occupancy_histogram(occ: np.ndarray, bins: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Histogram of per-block occupancies over [0, 1]."""
    return np.histogram(occ.ravel(), bins=bins, range=(0.0, 1.0))


def _layer_slices(leaf: dict):
    """Dense ternary (K, M) matrices, one per stacked layer, decoded one at a
    time so a (30, K/8, M) stack never becomes dense all at once."""
    if "sign" in leaf and "zero" in leaf:
        sign, zero = leaf["sign"], leaf["zero"]
        s3 = sign.reshape((-1,) + tuple(sign.shape[-2:]))
        z3 = zero.reshape((-1,) + tuple(zero.shape[-2:]))
        for i in range(s3.shape[0]):
            yield ternary.decode_planes(s3[i], z3[i], s3.shape[1] * ternary.PACK)
    elif "w" in leaf:
        w = leaf["w"]
        w3 = w.reshape((-1,) + tuple(w.shape[-2:]))
        for i in range(w3.shape[0]):
            yield ternary.absmean_ternarize(w3[i])[0]


def profile_params(params, bk: int = sparse_format.DEFAULT_BK,
                   bm: int = sparse_format.DEFAULT_BM, bins: int = 10) -> list[dict]:
    """Per-BitLinear-layer density profile: a list of ``{path, shape,
    density, block_density, hist, edges}``; a stacked weight is one entry
    over its whole stack."""
    out = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        keys = set(node)
        if not ({"sign", "zero"} <= keys or keys == {"w"}):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
            return
        occs, nnz, size = [], 0, 0
        for t in _layer_slices(node):
            occs.append(block_occupancy(t, bk, bm))
            nnz += int(torch.count_nonzero(t))
            size += t.numel()
        if not occs:
            return
        occ = torch.cat(occs, dim=0).cpu().numpy()
        hist, edges = occupancy_histogram(occ, bins)
        # pack_linear stamps the measured density at freeze time; prefer it
        # (the planes' ragged pad rows count as zeros, the stamp does not).
        if "density" in node:
            density = float(torch.mean(node["density"].to(torch.float32)))
        else:
            density = nnz / max(size, 1)
        if "sign" in node:
            ps = tuple(node["sign"].shape)
            shape = ps[:-2] + (ps[-2] * ternary.PACK, ps[-1])
        else:
            shape = tuple(node["w"].shape)
        out.append({"path": path, "shape": shape, "density": density,
                    "block_density": float((occ > 0).mean()),
                    "hist": hist, "edges": edges})

    walk(params, "")
    return out


def summarize(profile: list[dict]) -> dict:
    """Aggregate a :func:`profile_params` report into scalar telemetry."""
    if not profile:
        return {"layers": 0, "density_mean": float("nan"),
                "density_min": float("nan"), "block_density_mean": float("nan")}
    d = [p["density"] for p in profile]
    b = [p["block_density"] for p in profile]
    return {
        "layers": len(profile),
        "density_mean": sum(d) / len(d),
        "density_min": min(d),
        "block_density_mean": sum(b) / len(b),
    }
