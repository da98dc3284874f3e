"""Config -> model dispatch and the block-paged KV cache plumbing (port of
``repro/models/model_zoo.py``).

The inference entry points run under whatever execution plan the caller
activated (``repro_torch.plan.runtime.activate``, as the serving engine does
around every call); the reference's ``plan=`` argument is that context.

The attention K/V leaves are a pool of fixed-size token blocks,
(L, num_blocks, block_size, Hkv, Dh); per-slot block tables map a slot's
logical positions onto pool blocks.  Block 0 is reserved scratch: table
padding points at it, so gathers and scatters of unallocated entries touch
garbage that the attention mask never reads.  Every other leaf (the SSM
conv tail and SSD state, the enc-dec cross K/V) is O(1) per slot and stays
dense with a slot axis, (L, slots, ...): the view passes it through and the
scatter writes it back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer

PAGED_LEAVES = ("k", "v")


def _mod(cfg):
    return encdec if cfg.family == "encdec" else transformer


def init_params(cfg, generator: torch.Generator | None, device="cuda") -> dict:
    """Latent params drawn from ``generator``, which lives on ``device``;
    on ``device="meta"`` pass None: the tree carries shapes and dtypes
    only."""
    return _mod(cfg).init_params(cfg, generator, device)


def forward(cfg, params, batch, train=True, remat=False):
    """Teacher-forced logits and aux; see ``transformer.forward`` and
    ``encdec.forward``."""
    return _mod(cfg).forward(cfg, params, batch, train, remat=remat)


def loss_fn(cfg, params, batch, train=True, remat=False):
    """(loss, {"nll", "aux"}); see ``transformer.loss_fn`` and
    ``encdec.loss_fn``."""
    return _mod(cfg).loss_fn(cfg, params, batch, train, remat=remat)


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.float32, device="cuda"):
    return _mod(cfg).init_cache(cfg, batch_size, max_len, dtype, device)


def prefill(cfg, params, batch, cache, train=False):
    """Whole-prompt prefill; see ``transformer.prefill`` and
    ``encdec.prefill`` (whose batch carries ``frames``)."""
    return _mod(cfg).prefill(cfg, params, batch, cache, train)


def decode_step(cfg, params, tokens, cache, t, train=False):
    """One synchronous decode step at length ``t``; see
    ``transformer.decode_step``."""
    return _mod(cfg).decode_step(cfg, params, tokens, cache, t, train)


def chunk_step(cfg, params, tokens, pos, cache, lengths, train=False):
    """Per-slot chunked-append step (paged serving engine, ``chunked``
    policy): tokens/pos (B, C), lengths (B,) per-slot write offsets.  A
    slot's first chunk may start at a nonzero ``lengths[i]`` against a
    pre-populated block table (prefix-cache fork).  See
    ``transformer.chunk_step``."""
    return _mod(cfg).chunk_step(cfg, params, tokens, pos, cache, lengths, train)


def flat_step(cfg, params, tokens, slot, pos, cache, emit_row, train=False):
    """Flat token-packed step; see ``transformer.flat_step``."""
    return _mod(cfg).flat_step(cfg, params, tokens, slot, pos, cache, emit_row, train)


def init_paged_cache(cfg, slots: int, num_blocks: int, block_size: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Pool-shaped decode caches, zero-filled: paged K/V pools
    (L, num_blocks, block_size, Hkv, Dh) and dense per-slot state."""
    dev = resolve_device(device)
    pools = {}
    for name, shape in _mod(cfg).cache_shapes(cfg, slots, block_size).items():
        if name in PAGED_LEAVES:
            shape = (shape[0], num_blocks) + tuple(shape[2:])
        pools[name] = torch.zeros(shape, dtype=dtype, device=dev)
    return pools


def gather_cache_view(pools: dict, block_table: torch.Tensor) -> dict:
    """Contiguous per-slot cache view through block tables.

    block_table (B, VB) integer — each slot's first VB blocks (0-padded).
    Paged leaves (L, NB, bs, ...) -> (L, B, VB*bs, ...), a fresh copy; dense
    leaves pass through (the pool tensor itself).
    """
    view = {}
    idx = block_table.long()
    for name, leaf in pools.items():
        if name not in PAGED_LEAVES:
            view[name] = leaf
            continue
        l, _, bs = leaf.shape[:3]
        b, vb = idx.shape
        view[name] = leaf[:, idx].reshape((l, b, vb * bs) + tuple(leaf.shape[3:]))
    return view


def first_writers(block_table: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The write index of :func:`scatter_cache_view` for the host block
    table (B, VB): the distinct pool blocks it holds and, for each, the flat
    table position of its first entry (row-major: slot 0's entries first),
    as int64 tensors on ``device``.  Computed on the host, where the table
    is built, so a step's scatter needs no device synchronisation."""
    blocks, first = np.unique(np.asarray(block_table).reshape(-1), return_index=True)
    return (torch.as_tensor(blocks, dtype=torch.int64).to(device),
            torch.as_tensor(first, dtype=torch.int64).to(device))


def scatter_cache_view(pools: dict, writers: tuple, view: dict) -> dict:
    """Write an updated view back into the block pools, in place (the
    reference returns new pools; updating in place saves a pool copy per
    step).  Returns ``pools``.

    Tables repeat pool blocks: scratch block 0 in their padding, and, with
    the prefix cache, a full block that several slots forked.  Each distinct
    block is written once, from the first slot whose table holds it
    (``writers``, from :func:`first_writers` of the table the view was
    gathered through), so the result does not depend on the order of
    duplicate writes nor on the copies of a shared block agreeing in every
    slot's view.  Dense leaves take the view's tensor.
    """
    blocks, first = writers
    for name, leaf in pools.items():
        if name not in PAGED_LEAVES:
            pools[name] = view[name]
            continue
        l, _, bs = leaf.shape[:3]
        b, t = view[name].shape[1:3]
        rows = view[name].reshape((l, b * (t // bs), bs) + tuple(leaf.shape[3:]))
        leaf[:, blocks] = rows[:, first]
    return pools


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins, the dry-run contract)
# ---------------------------------------------------------------------------

def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, cache_dtype=torch.bfloat16) -> dict:
    """Model inputs for one (arch x shape) cell, as meta tensors (the
    reference's ``ShapeDtypeStruct``s: same shapes and dtypes).

    * train/prefill cells: full-sequence token batches (+ frontend stubs).
      For the VLM the patch tokens take the first ``frontend_seq`` positions
      of the cell's ``seq_len``, so the backbone's length is ``seq_len``.
    * decode cells: one new token per sequence, the KV/SSM caches sized to
      ``seq_len`` and the step's length ``t``.
    """
    b, s = shape.global_batch, shape.seq_len
    kind = shape.kind
    specs: dict = {}
    if kind in ("train", "prefill"):
        s_text = s
        if cfg.family == "vlm":
            s_text = s - cfg.frontend_seq
            specs["patches"] = _meta((b, cfg.frontend_seq, cfg.frontend_dim), torch.float32)
        if cfg.family == "encdec":
            specs["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), torch.float32)
        specs["tokens"] = _meta((b, s_text), torch.int32)
        if kind == "train":
            specs["labels"] = _meta((b, s_text), torch.int32)
        else:
            specs["cache"] = init_cache(cfg, b, s, cache_dtype, "meta")
    else:
        specs["tokens"] = _meta((b, 1), torch.int32)
        specs["cache"] = init_cache(cfg, b, s, cache_dtype, "meta")
        specs["t"] = _meta((), torch.int32)
    return specs


def param_specs(cfg) -> dict:
    """The latent params tree on the meta device (no allocation)."""
    return init_params(cfg, None, "meta")
