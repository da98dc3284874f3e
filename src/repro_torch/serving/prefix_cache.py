"""Prefix-caching KV reuse (port of ``repro/serving/prefix_cache.py``): a
block-granular radix tree over token-ID prefixes, with ref-counted KV blocks
and LRU eviction.  Pure host code over the port's ``PagedKVCache``.

T-SAR's in-register GEMV makes decode compute nearly free, so at serving
scale the cost center shifts to prefill work and KV memory traffic.  Real
multi-tenant traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn history — and the block-paged KV cache
already stores K/V in fixed-size blocks, the natural substrate for
automatic reuse: if two requests share their first ``k * block_size``
tokens, their first ``k`` KV blocks are bit-identical (RoPE is applied at
absolute positions, and a shared prefix starts at position 0), so the
second request can *fork* the first one's blocks instead of recomputing
them.

Data structure
--------------

A radix tree keyed by **full blocks** of token IDs: each node stands for one
pool block whose ``block_size`` tokens extend its parent's prefix.  Nodes
carry a chained content hash (``hash(parent_hash, block_tokens)``) stamped
into ``PagedKVCache.block_hash`` so the tree and the pool can be
cross-checked.  The tree holds one pool reference per cached block
(``kv.acquire`` at registration), on top of whatever references live slots
hold — so the pool-level refcount is the single source of truth for "may
this block be freed".

Correctness invariants (enforced by construction, asserted in
``tests/test_torch_prefix_cache.py``):

* **no block is freed while referenced** — blocks only return to the free
  list through ``kv.release`` when the last holder lets go;
* **eviction never touches live slots** — a node is evictable only when it
  is a leaf and the cache holds the block's ONLY reference
  (``refcount == 1``); interior nodes become evictable leaf-by-leaf, so a
  chain a slot still reads is never broken mid-path;
* **the hit path is token-identical to the cold path** — a fork installs
  blocks whose contents equal what the slot's own prefill would have
  written (same tokens, same absolute positions, same deterministic math),
  and the fork boundary is block-aligned and <= ``len(prompt) - 1``, so the
  partial last block and at least one real token are always recomputed
  (the recomputed chunk produces the first logit; copy-on-write divergence
  therefore reduces to "don't share the diverging block").

Eviction is LRU over evictable leaves: every match/registration touch
stamps a monotone tick along the path, and ``evict`` removes the
least-recently-used evictable leaf first — either on demand when the
allocator runs short (``kv.evictor`` hook, consulted by
``PagedKVCache.ensure`` *before* the scheduler resorts to preempting a live
request) or eagerly when a ``capacity_blocks`` bound is exceeded.
"""
from __future__ import annotations

from repro_torch.obs import NULL_TRACER

_ROOT_HASH = hash("tsar-prefix-root")


def chain_hash(parent_hash: int, key: tuple) -> int:
    """Chained content hash of one block extending ``parent_hash``."""
    return hash((parent_hash, key))


class _Node:
    __slots__ = ("key", "hash", "block", "parent", "children", "last_used")

    def __init__(self, key, h, block, parent):
        self.key = key          # tuple of this block's token IDs
        self.hash = h           # chain_hash(parent.hash, key)
        self.block = block      # pool block id holding the KV rows
        self.parent = parent
        self.children: dict = {}
        self.last_used = 0


class PrefixCache:
    """Ref-counted radix cache over a :class:`PagedKVCache` block pool.

    The cache registers itself as ``kv.evictor`` so allocator pressure
    reclaims stale cached blocks before any live request is preempted.
    """

    def __init__(self, kv, capacity_blocks: int | None = None):
        if capacity_blocks is not None and capacity_blocks < 1:
            raise ValueError(f"capacity_blocks={capacity_blocks} must be >= 1")
        self.kv = kv
        self.block_size = kv.block_size
        self.capacity = capacity_blocks   # None: bounded only by the pool
        self.root = _Node((), _ROOT_HASH, -1, None)
        self._size = 0
        self._tick = 0
        # -- telemetry --
        self.lookups = 0          # fork() calls (one per chunked admission)
        self.hits = 0             # forks that reused >= 1 block
        self.hit_tokens = 0       # prompt tokens served from cache
        self.miss_tokens = 0      # prompt tokens that had to be prefilled
        self.evictions = 0
        # insert() CALLS (not blocks added): the engine registers each
        # request's content exactly once per lifecycle event (prefill end,
        # finish, preemption); tests pin single registration against this.
        self.inserts = 0
        self.tracer = NULL_TRACER   # set by ServingEngine
        kv.evictor = self

    # -- properties ----------------------------------------------------------

    @property
    def cached_blocks(self) -> int:
        return self._size

    @property
    def hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from cache."""
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    # -- lookup / fork -------------------------------------------------------

    def _walk(self, tokens) -> list[_Node]:
        """Longest cached full-block path matching ``tokens``, capped so the
        last token (and any partial last block) is always recomputed."""
        bs = self.block_size
        cap_blocks = max(0, (len(tokens) - 1) // bs)
        node, path = self.root, []
        for j in range(cap_blocks):
            key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            nxt = node.children.get(key)
            if nxt is None:
                break
            path.append(nxt)
            node = nxt
        return path

    def match(self, tokens) -> tuple[int, list[int]]:
        """(cached_len, block_ids) for the longest reusable prefix.  Pure
        query: no references taken, no stats or LRU updates — the admission
        gate uses this to size its block budget before committing."""
        path = self._walk(tokens)
        return len(path) * self.block_size, [n.block for n in path]

    def fork(self, slot: int, tokens) -> int:
        """Install the longest cached prefix of ``tokens`` into empty
        ``slot`` (one pool reference per block, ``kv.lengths`` advanced to
        the fork boundary) and return ``cached_len``.  Counts hit/miss
        telemetry — call exactly once per chunked admission."""
        self.lookups += 1
        path = self._walk(tokens)
        self._tick += 1
        for n in path:
            n.last_used = self._tick
        cached = len(path) * self.block_size
        self.hit_tokens += cached
        self.miss_tokens += len(tokens) - cached
        if path:
            self.hits += 1
            self.kv.fork_blocks(slot, [n.block for n in path])
            self.kv.lengths[slot] = cached
        return cached

    # -- registration --------------------------------------------------------

    def insert(self, tokens, table_row) -> int:
        """Register a slot's finished prefix: every FULL block of ``tokens``
        (whose KV rows live at ``table_row[j]``) joins the tree.  Existing
        nodes are touched, not replaced — concurrent cold prefills of the
        same prompt produce bit-identical blocks, so first-writer-wins is
        sound and the loser's blocks simply stay exclusive to its slot.
        Returns the number of newly cached blocks."""
        bs = self.block_size
        self.inserts += 1
        n_full = len(tokens) // bs
        node, added = self.root, 0
        self._tick += 1
        for j in range(n_full):
            key = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                blk = int(table_row[j])
                child = _Node(key, chain_hash(node.hash, key), blk, node)
                self.kv.acquire(blk)              # cache's own reference
                self.kv.block_hash[blk] = child.hash
                node.children[key] = child
                self._size += 1
                added += 1
            child.last_used = self._tick
            node = child
        if added and self.tracer.enabled:
            self.tracer.instant("prefix_insert", added=added,
                                cached_blocks=self._size)
        if self.capacity is not None and self._size > self.capacity:
            self.evict(self._size - self.capacity, cause="capacity")
        return added

    # -- eviction (the kv.evictor protocol) ----------------------------------

    def evictable(self) -> int:
        """Blocks the cache could free right now: nodes whose whole subtree
        is unreferenced outside the cache (leaf-first eviction reaches them
        all)."""

        def rec(n: _Node) -> tuple[int, bool]:
            cnt, all_ok = 0, True
            for c in n.children.values():
                c_cnt, c_ok = rec(c)
                cnt += c_cnt
                all_ok = all_ok and c_ok
            if n is self.root:
                return cnt, True
            ok = all_ok and int(self.kv.refcount[n.block]) == 1
            return cnt + (1 if ok else 0), ok

        return rec(self.root)[0]

    def evict(self, n: int, cause: str = "pressure") -> int:
        """Free up to ``n`` cached blocks, least-recently-used evictable
        leaf first.  Never touches a block any slot still references.
        ``cause`` labels the traced eviction event: ``"pressure"`` (the
        allocator ran short — the ``kv.evictor`` hook's default),
        ``"capacity"`` (the ``capacity_blocks`` bound), ``"reset"``."""
        freed = 0
        while freed < n:
            leaf = None
            stack = [self.root]
            while stack:
                nd = stack.pop()
                for c in nd.children.values():
                    if c.children:
                        stack.append(c)
                    elif int(self.kv.refcount[c.block]) == 1:
                        if leaf is None or c.last_used < leaf.last_used:
                            leaf = c
            if leaf is None:
                break                      # everything left is still live
            del leaf.parent.children[leaf.key]
            self.kv.release(leaf.block)
            self._size -= 1
            self.evictions += 1
            freed += 1
        if freed and self.tracer.enabled:
            self.tracer.instant("prefix_evict", n=freed, cause=cause)
        return freed

    # -- invariants ----------------------------------------------------------

    def check(self) -> None:
        """Tree/pool consistency (test hook): every cached block is held,
        hashes chain correctly, and the size counter matches the tree."""
        n = 0
        stack = [self.root]
        while stack:
            nd = stack.pop()
            for c in nd.children.values():
                assert c.block != 0, "cache holds the scratch block"
                assert int(self.kv.refcount[c.block]) >= 1, c.block
                assert c.hash == chain_hash(nd.hash, c.key)
                assert self.kv.block_hash.get(c.block) == c.hash
                assert len(c.key) == self.block_size
                n += 1
                stack.append(c)
        assert n == self._size, (n, self._size)
        self.kv.check()

    def stats(self) -> dict:
        return {
            "cached_blocks": self.cached_blocks,
            "prefix_hit_rate": self.hit_rate,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_lookups": self.lookups,
            "prefix_evictions": self.evictions,
        }
