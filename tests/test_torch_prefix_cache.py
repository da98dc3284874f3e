"""The port's prefix cache: the radix-tree properties of the reference's
tests on ``repro_torch.serving.PrefixCache`` (seeded cases, no hypothesis),
one op sequence through both packages' caches, the engine's reuse cases,
the ``chunk_step`` nonzero-start contract and the shared-block write-back
of ``model_zoo.scatter_cache_view``."""
import numpy as np
import pytest
import torch
from _torch_serving import port_params, reference_frozen

import repro.configs as jconfigs
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import PrefixCache as JPrefixCache
from repro_torch.launch import serve
from repro_torch.models import model_zoo
from repro_torch.serving import PagedKVCache, PrefixCache, Request, ServingEngine

BS = 4  # block size of the data-structure tests


@pytest.fixture(scope="module")
def cfg():
    return jconfigs.get("bitnet-2b-4t").reduced()


@pytest.fixture(scope="module")
def model():
    return reference_frozen("bitnet-2b-4t")[0], port_params("bitnet-2b-4t")


def _mk(cfg, num_blocks=64, capacity=None):
    kv = PagedKVCache(cfg, slots=4, max_len=16 * BS, block_size=BS, num_blocks=num_blocks,
                      device="cpu")
    return kv, PrefixCache(kv, capacity_blocks=capacity)


def _fill_and_register(kv, cache, slot, tokens):
    """A finished prefill: blocks for ``tokens`` in ``slot``, full blocks
    registered."""
    assert kv.ensure(slot, len(tokens))
    kv.lengths[slot] = len(tokens)
    cache.insert(tokens, kv.table[slot])


# ---------------------------------------------------------------------------
# Radix tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_insert_lookup_roundtrip(cfg, seed):
    """A registered sequence matches back its full blocks capped below its
    length, with the registering slot's block ids; a freed slot's blocks
    stay cached."""
    rng = np.random.default_rng(seed)
    for n in rng.integers(1, 41, size=4):
        kv, pc = _mk(cfg)
        toks = rng.integers(0, 50, size=n).astype(np.int32)
        _fill_and_register(kv, pc, 0, toks)
        want_blocks = min(len(toks) // BS, max(0, (len(toks) - 1) // BS))
        cached, blocks = pc.match(toks)
        assert cached == want_blocks * BS
        assert blocks == [int(kv.table[0, j]) for j in range(want_blocks)]
        if len(toks) > BS:
            div = toks.copy()
            div[-1] = (div[-1] + 1) % 50
            assert pc.match(div)[0] <= cached
        pc.check()
        kv.free_slot(0)
        assert pc.match(toks)[0] == cached
        pc.check()


@pytest.mark.parametrize("seed", range(6))
def test_refcount_never_negative_random_ops(cfg, seed):
    """Seeded interleavings of fill/register/fork/free/evict keep every
    allocator and tree invariant; draining the cache frees every block."""
    kv, pc = _mk(cfg, num_blocks=40)
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 20, size=rng.integers(1, 3 * BS + 2)).astype(np.int32)
            for _ in range(4)]
    busy = set()
    for _ in range(30):
        op, slot = rng.integers(0, 4), int(rng.integers(0, 4))
        toks = seqs[int(rng.integers(0, len(seqs)))]
        if op == 0 and slot not in busy:
            cached = pc.fork(slot, toks)
            if kv.ensure(slot, len(toks)):
                kv.lengths[slot] = len(toks)
                pc.insert(toks, kv.table[slot])
                busy.add(slot)
            else:
                kv.free_slot(slot)
            assert cached % BS == 0 and cached < max(len(toks), 1)
        elif op == 1 and slot in busy:
            kv.free_slot(slot)
            busy.discard(slot)
        elif op == 2:
            pc.evict(int(rng.integers(1, 4)))
        else:
            pc.match(toks)
        pc.check()
    for slot in busy:
        kv.free_slot(slot)
    pc.check()
    pc.evict(pc.cached_blocks)
    pc.check()
    assert kv.blocks_in_use == 0


def test_eviction_order_is_lru(cfg):
    kv, pc = _mk(cfg)
    a, b, c = (np.arange(BS, dtype=np.int32) + base for base in (1, 100, 200))
    for slot, toks in enumerate((a, b, c)):
        _fill_and_register(kv, pc, slot, np.append(toks, 7))
        kv.free_slot(slot)
    assert pc.cached_blocks == 3
    assert pc.fork(0, np.append(a, 7)) == BS       # touch A
    kv.free_slot(0)
    pc.evict(1)
    assert pc.match(np.append(b, 7))[0] == 0       # B was least recently used
    assert pc.match(np.append(a, 7))[0] == BS
    assert pc.match(np.append(c, 7))[0] == BS
    pc.evict(2)
    assert pc.cached_blocks == 0 and kv.blocks_in_use == 0
    pc.check()


def test_eviction_never_touches_live_slots(cfg):
    kv, pc = _mk(cfg)
    toks = np.arange(3 * BS + 1, dtype=np.int32)
    _fill_and_register(kv, pc, 0, toks)
    kv.free_slot(0)
    assert pc.fork(1, toks) == 3 * BS              # slot 1 holds the chain
    assert pc.evict(10) == 0
    assert pc.evictable() == 0
    kv.free_slot(1)
    assert pc.evictable() == 3
    assert pc.evict(10) == 3
    pc.check()


def test_capacity_bound_evicts_lru(cfg):
    kv, pc = _mk(cfg, capacity=2)
    for base in (0, 100, 200):
        _fill_and_register(kv, pc, 0, np.append(np.arange(BS, dtype=np.int32) + base, 7))
        kv.free_slot(0)
    assert pc.cached_blocks <= 2
    assert pc.match(np.append(np.arange(BS, dtype=np.int32), 7))[0] == 0
    pc.check()


def test_partial_last_block_never_cached(cfg):
    kv, pc = _mk(cfg)
    _fill_and_register(kv, pc, 0, np.arange(BS - 1, dtype=np.int32))
    assert pc.cached_blocks == 0
    exact = np.arange(2 * BS, dtype=np.int32) + 50
    _fill_and_register(kv, pc, 1, exact)
    assert pc.match(exact)[0] == BS                # the last token stays uncached
    pc.check()


@pytest.mark.parametrize("seed", range(4))
def test_same_ops_as_reference(cfg, seed):
    """One seeded op sequence (fill / insert / match / fork / free / evict)
    through the reference's cache and the port's: equal match results, block
    ids, hashes, stats and free lists after every op."""
    caches = []
    for kv_cls, pc_cls, extra in ((JPagedKVCache, JPrefixCache, {}),
                                  (PagedKVCache, PrefixCache, {"device": "cpu"})):
        kv = kv_cls(cfg, slots=4, max_len=16 * BS, block_size=BS, num_blocks=24, **extra)
        caches.append((kv, pc_cls(kv, capacity_blocks=6 if seed % 2 else None)))
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 6, size=rng.integers(2, 4 * BS + 2)).astype(np.int32)
            for _ in range(5)]
    busy = set()
    for _ in range(40):
        op, slot = int(rng.integers(0, 5)), int(rng.integers(0, 4))
        toks = seqs[int(rng.integers(0, len(seqs)))]
        n_evict = int(rng.integers(1, 4))
        got = []
        for kv, pc in caches:
            if op == 0 and slot not in busy:
                out = [pc.fork(slot, toks), kv.ensure(slot, len(toks))]
                if out[1]:
                    kv.lengths[slot] = len(toks)
                    out.append(pc.insert(toks, kv.table[slot]))
                else:
                    kv.free_slot(slot)
            elif op == 1 and slot in busy:
                out = kv.free_slot(slot)
            elif op == 2:
                out = pc.evict(n_evict)
            else:
                out = pc.match(toks)
            pc.check()
            got.append((out, pc.stats(), list(kv._free), kv.table.tolist(),
                        kv.refcount.tolist(), dict(kv.block_hash)))
        assert got[1] == got[0]
        if op == 0 and slot not in busy and got[0][0][1]:
            busy.add(slot)
        elif op == 1:
            busy.discard(slot)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _shared(sys_prompt, n=4, tail=16, max_new=5):
    rng = np.random.default_rng(3)
    tails = [rng.integers(0, 90, size=tail).astype(np.int32) for _ in range(n)]
    return [Request(uid=i, prompt=np.concatenate([sys_prompt, tails[i]]),
                    max_new_tokens=max_new) for i in range(n)]


@pytest.mark.parametrize("policy", ["flat", "chunked"])
def test_shared_prefix_token_identical_and_cheaper(model, policy):
    """75 %-shared prompts under the prefix cache: the cold engine's tokens,
    fewer prefill tokens scheduled, a nonzero hit rate; a cache-off engine
    has no prefix keys."""
    cfg, params = model
    sys_prompt = (np.arange(48, dtype=np.int32) * 5 + 1) % 90
    kw = dict(max_len=128, batch_slots=2, prefill_chunk=8, policy=policy, device="cpu")
    off = ServingEngine(cfg, params, **kw)
    r_off = off.run(_shared(sys_prompt))
    on = ServingEngine(cfg, params, prefix_cache=True, **kw)
    r_on = on.run(_shared(sys_prompt))
    assert [r.out_tokens for r in r_on] == [r.out_tokens for r in r_off]
    assert on.sched.prefill_tokens_planned < off.sched.prefill_tokens_planned
    assert on.stats["prefill_tokens"] < off.stats["prefill_tokens"]
    assert on.sched.cached_tokens_skipped > 0
    assert on.stats["prefix_hit_rate"] > 0
    assert on.stats["prefix_hit_tokens"] >= 48
    assert "prefix_hit_rate" not in off.stats and "cached_blocks" not in off.stats
    on.prefix.check()


def test_multi_turn_reuse_via_generated_tokens(model):
    """A follow-up quoting prompt + answer of a finished request hits the
    registered generated blocks too."""
    cfg, params = model
    eng = ServingEngine(cfg, params, max_len=128, batch_slots=2, prefill_chunk=8,
                        block_size=4, prefix_cache=True, device="cpu")
    first = Request(uid=0, prompt=np.arange(24, dtype=np.int32) % 70, max_new_tokens=8)
    eng.run([first])
    follow = Request(uid=1, prompt=np.concatenate(
        [first.prompt, np.asarray(first.out_tokens, np.int32),
         np.arange(5, dtype=np.int32) + 7]), max_new_tokens=4)
    hit0 = eng.stats["prefix_hit_tokens"]
    eng.run([follow])
    # The prompt (24) and all but the last generated token (7) are cached.
    assert eng.stats["prefix_hit_tokens"] - hit0 == 28
    eng.prefix.check()


def test_preemption_with_shared_prefix_recovers(model):
    """Preempting requests whose blocks are shared releases references:
    tokens equal a roomy engine's and a cache-off engine's, and only cached
    blocks stay in use."""
    cfg, params = model
    sys_prompt = (np.arange(16, dtype=np.int32) * 3 + 2) % 80
    kw = dict(max_len=64, batch_slots=2, prefill_chunk=8, device="cpu")
    roomy = ServingEngine(cfg, params, prefix_cache=True, **kw).run(
        _shared(sys_prompt, n=3, tail=8, max_new=8))
    off = ServingEngine(cfg, params, **kw).run(_shared(sys_prompt, n=3, tail=8, max_new=8))
    tight_eng = ServingEngine(cfg, params, block_size=4, kv_blocks=16, prefix_cache=True, **kw)
    tight = tight_eng.run(_shared(sys_prompt, n=3, tail=8, max_new=8))
    assert all(r.done for r in tight)
    assert tight_eng.stats["preemptions"] > 0, "pool not tight enough to preempt"
    for a, b, c in zip(roomy, tight, off):
        assert a.out_tokens == b.out_tokens == c.out_tokens
    tight_eng.prefix.check()
    assert tight_eng.kv.blocks_in_use == tight_eng.prefix.cached_blocks


def test_preempted_partial_prefill_reused_at_readmission(model):
    """Pairwise-distinct prompts: the only reuse is a preempted request
    forking its own registered blocks back, so the cache-on engine schedules
    fewer prefill tokens than the cache-off engine on the same pool."""
    cfg, params = model

    def reqs():
        rng = np.random.default_rng(11)
        return [Request(uid=i, prompt=rng.integers(0, 90, size=30 + i), max_new_tokens=6)
                for i in range(3)]

    tight = dict(max_len=64, batch_slots=2, prefill_chunk=8, block_size=4, kv_blocks=16,
                 device="cpu")
    roomy = ServingEngine(cfg, params, max_len=64, batch_slots=2, prefill_chunk=8,
                          device="cpu").run(reqs())
    on = ServingEngine(cfg, params, prefix_cache=True, **tight)
    r_on = on.run(reqs())
    off = ServingEngine(cfg, params, **tight)
    r_off = off.run(reqs())
    assert on.stats["preemptions"] > 0 and on.sched.readmissions > 0
    assert on.sched.cached_tokens_skipped > 0 and off.sched.cached_tokens_skipped == 0
    assert on.sched.prefill_tokens_planned < off.sched.prefill_tokens_planned
    for a, b, c in zip(roomy, r_on, r_off):
        assert a.out_tokens == b.out_tokens == c.out_tokens
    on.prefix.check()


def test_pool_pressure_evicts_cache_before_preempting(model):
    """A pool mostly held by stale cached prefixes is reclaimed by the
    allocator's evictor hook; later requests finish without preemption."""
    cfg, params = model
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2, prefill_chunk=8,
                        block_size=4, kv_blocks=20, prefix_cache=True, device="cpu")
    rng = np.random.default_rng(0)
    eng.run([Request(uid=i, prompt=rng.integers(0, 90, size=20), max_new_tokens=4)
             for i in range(3)])
    assert eng.stats["cached_blocks"] > 0
    more = [Request(uid=9 + i, prompt=rng.integers(0, 90, size=24), max_new_tokens=4)
            for i in range(2)]
    eng.run(more)
    assert all(r.done and len(r.out_tokens) == 4 for r in more)
    assert eng.stats["prefix_evictions"] > 0
    assert eng.stats["preemptions"] == 0
    eng.prefix.check()


@pytest.mark.parametrize("policy", ["flat", "chunked"])
def test_finish_at_prefill_end_registers_once(model, policy):
    """A request whose last prefill chunk also emits its last token is
    registered once; one that keeps decoding twice (prefill end, finish)."""
    cfg, params = model
    for max_new, inserts in ((1, 1), (4, 2)):
        eng = ServingEngine(cfg, params, max_len=64, batch_slots=2, prefill_chunk=8,
                            policy=policy, prefix_cache=True, device="cpu")
        eng.run([Request(uid=0, prompt=np.arange(24, dtype=np.int32),
                         max_new_tokens=max_new)])
        assert eng.prefix.inserts == inserts


def test_prefix_cache_cap_and_reset(model):
    """An int caps the cached blocks: a registration above the cap evicts
    the unreferenced ones, least recently used first (a live slot's blocks
    stay).  ``reset_run_stats`` empties the tree and the pool and zeroes the
    prefix counters."""
    cfg, params = model
    eng = ServingEngine(cfg, params, max_len=64, batch_slots=2, prefill_chunk=8,
                        block_size=4, prefix_cache=3, device="cpu")
    assert eng.prefix.capacity == 3
    for uid in range(2):
        eng.run([Request(uid=uid, prompt=np.arange(30, dtype=np.int32) + 40 * uid,
                         max_new_tokens=3)])
    # Each request leaves 8 full blocks (30 + 2 positions); the second's
    # registrations evict all 8 of the first's.
    assert eng.stats["cached_blocks"] == 8 and eng.stats["prefix_evictions"] == 8
    eng.reset_run_stats()
    assert eng.kv.blocks_in_use == 0 and eng.prefix.capacity == 3
    assert eng.stats["cached_blocks"] == eng.stats["prefix_evictions"] == 0
    assert eng.stats["steps"] == 0 and eng.stats["peak_kv_blocks"] == 0


@pytest.mark.parametrize("flag,capacity", [(["--prefix-cache"], None),
                                           (["--prefix-cache", "6"], 6)])
def test_serve_cli_prefix_cache(flag, capacity, capsys):
    eng, reqs = serve.main(["--arch", "bitnet-2b-4t", "--smoke", "--device", "cpu",
                            "--requests", "3", "--max-new", "2", *flag])
    assert all(r.done for r in reqs)
    assert eng.prefix is not None and eng.prefix.capacity == capacity
    assert "prefix cache: hit rate" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Model-level contracts
# ---------------------------------------------------------------------------

def test_chunk_step_accepts_nonzero_start(model):
    """A chunk starting at lengths[i] > 0 over a pre-populated cache matches
    the same positions computed in one chunk."""
    cfg, params = model
    s, split = 24, 16
    toks = torch.from_numpy((np.arange(s, dtype=np.int64) * 11 + 3) % 80)[None]
    pos = torch.arange(s)[None]
    logits_a, cache_a = model_zoo.chunk_step(cfg, params, toks, pos,
                                             model_zoo.init_cache(cfg, 1, 32, device="cpu"),
                                             torch.zeros(1, dtype=torch.long))
    _, cache_b = model_zoo.chunk_step(cfg, params, toks[:, :split], pos[:, :split],
                                      model_zoo.init_cache(cfg, 1, 32, device="cpu"),
                                      torch.zeros(1, dtype=torch.long))
    logits_b, cache_b = model_zoo.chunk_step(cfg, params, toks[:, split:], pos[:, split:],
                                             cache_b, torch.full((1,), split))
    torch.testing.assert_close(logits_b[:, -1], logits_a[:, -1], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(cache_b["k"][:, :, :s], cache_a["k"][:, :, :s],
                               rtol=2e-5, atol=2e-5)


def test_scatter_writes_shared_block_once(model):
    """Slots 0 and 1 share pool block 1 (a forked prefix) and own blocks 2
    and 3.  One flat step writes rows into both slots' tails: the shared
    block comes out bit-identical, each tail holds its own slot's rows.
    Where the two views' copies of the shared block disagree, slot 0's copy
    is the one written."""
    cfg, params = model
    bs = 8
    pools = model_zoo.init_paged_cache(cfg, 2, 5, bs, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in pools.values():
        leaf[:, 1] = torch.randn(leaf[:, 1].shape, generator=gen)
    shared = {n: leaf[:, 1].clone() for n, leaf in pools.items()}
    table = torch.tensor([[1, 2], [1, 3]])
    writers = model_zoo.first_writers(table.numpy(), "cpu")
    view = model_zoo.gather_cache_view(pools, table)
    tokens = torch.tensor([5, 6, 7, 8, 9, 0])
    slot = torch.tensor([0, 0, 0, 1, 1, 2])
    pos = torch.tensor([8, 9, 10, 8, 9, 0])
    _, view = model_zoo.flat_step(cfg, params, tokens, slot, pos, view, torch.tensor([2, 4]))
    model_zoo.scatter_cache_view(pools, writers, view)
    for n, leaf in pools.items():
        assert torch.equal(leaf[:, 1], shared[n])
        assert torch.equal(leaf[:, 2], view[n][:, 0, bs:])
        assert torch.equal(leaf[:, 3], view[n][:, 1, bs:])
        assert not torch.equal(leaf[:, 2, :3], leaf[:, 3, :3])
    view["k"][:, 1, :bs] += 1.0                     # slot 1's copy drifts
    model_zoo.scatter_cache_view(pools, writers, view)
    assert torch.equal(pools["k"][:, 1], shared["k"])
