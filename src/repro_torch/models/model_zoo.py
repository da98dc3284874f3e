"""Config -> model dispatch and the block-paged KV cache plumbing (port of
``repro/models/model_zoo.py``).

The attention K/V leaves are a pool of fixed-size token blocks,
(L, num_blocks, block_size, Hkv, Dh); per-slot block tables map a slot's
logical positions onto pool blocks.  Block 0 is reserved scratch: table
padding points at it, so gathers and scatters of unallocated entries touch
garbage that the attention mask never reads.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer

PAGED_LEAVES = ("k", "v")


def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    return transformer.init_params(cfg, generator, device)


def flat_step(cfg, params, tokens, slot, pos, cache, emit_row):
    """Flat token-packed step; see ``transformer.flat_step``."""
    return transformer.flat_step(cfg, params, tokens, slot, pos, cache, emit_row)


def init_paged_cache(cfg, slots: int, num_blocks: int, block_size: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Paged K/V pools (L, num_blocks, block_size, Hkv, Dh), zero-filled."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"init_paged_cache: only the dense family is ported (got {cfg.family!r})")
    dev = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name in PAGED_LEAVES}


def gather_cache_view(pools: dict, block_table: torch.Tensor) -> dict:
    """Contiguous per-slot cache view through block tables.

    block_table (B, VB) integer — each slot's first VB blocks (0-padded).
    Paged leaves (L, NB, bs, ...) -> (L, B, VB*bs, ...), a fresh copy.
    """
    view = {}
    idx = block_table.long()
    for name, leaf in pools.items():
        l, _, bs = leaf.shape[:3]
        b, vb = idx.shape
        view[name] = leaf[:, idx].reshape((l, b, vb * bs) + tuple(leaf.shape[3:]))
    return view


def scatter_cache_view(pools: dict, block_table: torch.Tensor, view: dict) -> dict:
    """Write an updated view back into the block pools, in place (the
    reference returns new pools; updating in place saves a pool copy per
    step).  Returns ``pools``.

    Table entries repeat only block 0 (scratch), so the order in which
    duplicate writes land does not matter: scratch is never read as live
    data.  That stops holding once the prefix cache lets two slots' tables
    share a real block; the scatter must then write each block once.
    """
    idx = block_table.long()
    for name, leaf in pools.items():
        l, _, bs = leaf.shape[:3]
        b, vb = idx.shape
        leaf[:, idx] = view[name].reshape((l, b, vb, bs) + tuple(leaf.shape[3:]))
    return pools
