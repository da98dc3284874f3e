"""Block-paged KV cache for the serving engine (port of
``repro/serving/kv_cache.py``; vLLM-style paged attention).  The allocator
is numpy on the host; the pools are torch tensors on the device.

Device memory holds one *pool* of fixed-size token blocks per attention K/V
leaf, (L, num_blocks, block_size, Hkv, Dh), instead of a dense
(slots, max_len) cache — so resident KV memory is proportional to live
tokens, not to ``slots * max_len``.  A host-side free-list allocator hands
blocks to slots; each slot's logical token positions map onto pool blocks
through a per-slot block table.

Before each model call the engine gathers the active slots' blocks into a
contiguous (L, B, V, Hkv, Dh) view (V is a power-of-two bucket of block
counts), runs the step, and scatters the view's blocks back.  Gather/scatter
live in ``model_zoo.gather_cache_view`` / ``scatter_cache_view``.

Block 0 is reserved scratch: unallocated table entries point at it, so the
static-shape gather/scatter of a short slot's padding reads/writes garbage
that the causal mask guarantees is never attended.  O(1)-per-slot state (SSM
conv tail + SSD state, enc-dec cross K/V) is not paged; it stays dense with a
leading slot axis inside the same cache pytree.

Blocks are **ref-counted** so the prefix cache (``serving.prefix_cache``) can
share one physical block between several slots and its own radix tree:

* ``ensure`` allocates exclusive blocks (refcount 1);
* ``fork_blocks`` installs existing blocks into an empty slot's table and
  takes a reference each — the block-sharing primitive behind prefix reuse
  (the forked region is read-only by construction: every write lands at
  offsets >= the fork boundary, which is block-aligned);
* ``release`` / ``free_slot`` drop references; a block returns to the free
  list only when its LAST holder lets go, so recompute-preemption of one
  request can never corrupt blocks another request (or the prefix cache)
  still reads;
* ``acquire`` takes an extra reference on an already-owned block (the prefix
  cache registering a finished prefix);
* ``evictor`` — an optional object with ``evictable() -> int`` and
  ``evict(n) -> int`` — is consulted by ``ensure``/``can_allocate`` when the
  free list runs short, so cached-but-unreferenced blocks are reclaimed
  before the scheduler resorts to preempting a live request.

``block_hash`` carries the prefix cache's chained content hash per cached
block (stamped at registration, dropped when the block is freed) — purely
introspective, but it lets tests assert the tree and the pool agree.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model_zoo
from repro_torch.obs import NULL_TRACER


class PagedKVCache:
    """Free-list block allocator + block tables over ``model_zoo`` pools."""

    def __init__(self, cfg, slots: int, max_len: int, *, block_size: int = 16,
                 num_blocks: int | None = None, dtype=torch.float32,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = max(1, math.ceil(max_len / block_size))
        if num_blocks is None:
            # Safe default: every slot can grow to max_len (+1 scratch block).
            num_blocks = slots * self.max_blocks + 1
        if num_blocks < 2:
            raise ValueError("need at least one scratch + one real block")
        self.num_blocks = num_blocks
        self.pools = model_zoo.init_paged_cache(cfg, slots, num_blocks,
                                                block_size, dtype, self.device)
        # Host-side allocator state.  Block 0 is reserved scratch.
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self.table = np.zeros((slots, self.max_blocks), np.int32)
        self.n_blocks = np.zeros(slots, np.int32)     # allocated blocks / slot
        self.lengths = np.zeros(slots, np.int32)      # live tokens / slot
        self.refcount = np.zeros(num_blocks, np.int32)
        self.refcount[0] = 1                          # scratch: pinned forever
        self.block_hash: dict[int, int] = {}          # cached-content hashes
        self.evictor = None                           # set by a prefix cache
        self.tracer = NULL_TRACER                     # set by ServingEngine
        self.incidents = None                         # set by ServingEngine

    # -- allocator ----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        """Can the pool cover ``n_tokens`` of fresh blocks?  Counts blocks the
        evictor could reclaim (cached, referenced by nobody else) alongside
        the free list — a pool full of stale cached prefixes is still
        allocatable, the eviction just happens inside :meth:`ensure`."""
        avail = len(self._free)
        if self.evictor is not None:
            avail += self.evictor.evictable()
        return avail >= self.blocks_for(n_tokens)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens`` positions.  Returns
        False (allocating nothing) if the free list — after asking the
        evictor to reclaim unreferenced cached blocks — cannot cover the
        growth."""
        need = self.blocks_for(n_tokens)
        if need > self.max_blocks:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens > max_len {self.max_len}")
        grow = need - int(self.n_blocks[slot])
        if grow <= 0:
            return True
        if grow > len(self._free) and self.evictor is not None:
            if self.tracer.enabled:
                # Allocator pressure: the free list alone can't cover this
                # growth and the evictor is being consulted — the causal
                # precursor of prefix evictions and (if those fall short)
                # preemptions in the timeline analysis.
                self.tracer.instant("kv_pressure", slot=slot, need=grow,
                                    free=len(self._free))
            if self.incidents is not None:
                # Outside the tracer guard: incident snapshots fire with
                # tracing on or off.
                self.incidents.observe("kv_pressure", slot=slot, need=grow,
                                       free=len(self._free))
            self.evictor.evict(grow - len(self._free))
        if grow > len(self._free):
            return False
        for j in range(int(self.n_blocks[slot]), need):
            b = self._free.pop()
            self.refcount[b] = 1
            self.table[slot, j] = b
        self.n_blocks[slot] = need
        return True

    def acquire(self, block: int) -> None:
        """Take an extra reference on an already-referenced block (prefix-
        cache registration of a live slot's block)."""
        if block == 0 or self.refcount[block] < 1:
            raise ValueError(f"acquire of unowned block {block}")
        self.refcount[block] += 1

    def release(self, block: int) -> None:
        """Drop one reference; the last holder returns the block to the free
        list.  Contents are recycled dirty — safe because a new owner starts
        writing at offset 0 of its logical positions and the causal mask
        never reads past a slot's live length."""
        if block == 0:
            raise ValueError("release of the scratch block")
        self.refcount[block] -= 1
        if self.refcount[block] < 0:
            raise AssertionError(f"refcount underflow on block {block}")
        if self.refcount[block] == 0:
            self._free.append(block)
            self.block_hash.pop(block, None)

    def fork_blocks(self, slot: int, blocks: list[int]) -> None:
        """Install shared ``blocks`` as the leading entries of an EMPTY
        slot's table, taking one reference each.  The caller (prefix cache)
        guarantees the slot only ever writes at positions >= the forked
        region, so no copy is needed until/unless content diverges — and
        divergence is handled at block granularity by simply not sharing the
        diverging block (recompute instead of copy)."""
        if int(self.n_blocks[slot]) != 0:
            raise ValueError(f"fork into non-empty slot {slot}")
        if len(blocks) > self.max_blocks:
            raise ValueError(f"fork of {len(blocks)} blocks > max_blocks")
        for j, b in enumerate(blocks):
            if b == 0 or self.refcount[b] < 1:
                raise ValueError(f"fork of unowned block {b}")
            self.refcount[b] += 1
            self.table[slot, j] = b
        self.n_blocks[slot] = len(blocks)

    def free_slot(self, slot: int) -> None:
        """Release a finished slot's block references.  Blocks shared with
        the prefix cache (or another slot) survive with their remaining
        holders; exclusively-owned blocks return to the free list."""
        for j in range(int(self.n_blocks[slot])):
            self.release(int(self.table[slot, j]))
        self.table[slot, :] = 0
        self.n_blocks[slot] = 0
        self.lengths[slot] = 0

    # -- step views ---------------------------------------------------------

    def view_blocks(self, n_tokens: int) -> int:
        """Power-of-two bucket of blocks covering ``n_tokens`` positions
        (bounds the distinct view shapes to O(log max_blocks)).

        May exceed ``max_blocks``: a chunk-wide write starting near max_len
        must fit inside the view.  ``host_table`` pads
        the extra columns with scratch-block entries."""
        need = max(1, self.blocks_for(max(1, n_tokens)))
        vb = 1
        while vb < need:
            vb *= 2
        return vb

    def host_table(self, view_blocks: int) -> np.ndarray:
        """(slots, view_blocks) block table on the host."""
        if view_blocks <= self.max_blocks:
            return self.table[:, :view_blocks]
        pad = np.zeros((self.slots, view_blocks - self.max_blocks), np.int32)
        return np.concatenate([self.table, pad], axis=1)

    def table_view(self, view_blocks: int) -> torch.Tensor:
        """:meth:`host_table` as an int32 tensor on the pools' device."""
        return torch.from_numpy(np.ascontiguousarray(self.host_table(view_blocks))).to(
            self.device)

    def live_tokens(self) -> int:
        """Live tokens over every slot."""
        return int(self.lengths.sum())

    # -- invariants ----------------------------------------------------------

    def check(self) -> None:
        """Allocator invariants (test/debug hook): refcounts never negative,
        the free list holds exactly the zero-refcount blocks, and every live
        table entry references a held block."""
        assert (self.refcount >= 0).all(), "negative refcount"
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entry"
        for b in range(1, self.num_blocks):
            if b in free:
                assert self.refcount[b] == 0, f"free block {b} still referenced"
            else:
                assert self.refcount[b] >= 1, f"leaked block {b} (refcount 0)"
        for s in range(self.slots):
            for j in range(int(self.n_blocks[s])):
                b = int(self.table[s, j])
                assert b != 0 and self.refcount[b] >= 1, (s, j, b)
