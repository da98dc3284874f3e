"""Port vs reference: the compacted block-sparse format and the compacted
sparse kernel's plain version.

The same numpy-seeded ternary matrices go through
``repro.sparse.format.from_ternary`` and the port's: pools, block map,
occupancy and walk must be byte-equal, an all-dead matrix and ragged K/M
included, and so must the conversions between the compacted and padded
formats.  ``repro_torch.kernels.ops.tsar_sparse_matmul`` on CPU tensors
(the kernel's plain version) is held bit-exact against the reference Pallas
kernel in interpret mode, both oracles and the dense ``tsar_matmul``.  The
CUDA kernel runs only on the GPU (the ``gpu`` test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import format as jformat
from repro_torch.core import ternary
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tsar_sparse as ts
from repro_torch.sparse import format as sformat
from repro_torch.sparse import stats

FIELDS = ("sign_pool", "zero_pool", "block_map", "occupancy", "scale", "kids",
          "slots", "counts")
PADDED_FIELDS = FIELDS


def _block_sparse(k, m, bk, bm, p_dead, seed, dead_strip=False):
    """Ternary (K, M) int8 with a seeded fraction of (bk, bm) blocks dead;
    ``dead_strip`` kills every block of m-strip 0."""
    rng = np.random.default_rng(seed)
    kb, mb = -(-k // bk), -(-m // bm)
    dead = rng.random((kb, mb)) < p_dead
    if dead_strip:
        dead[:, 0] = True
    t = rng.integers(-1, 2, size=(k, m)).astype(np.int8)
    t *= np.repeat(np.repeat(~dead, bk, 0), bm, 1)[:k, :m].astype(np.int8)
    scale = (rng.random(m) + 0.05).astype(np.float32)
    return t, scale


def _assert_same(got, want, fields):
    for f in fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


def _compact_both(t, scale, bk, bm):
    j = jformat.from_ternary(jnp.asarray(t), jnp.asarray(scale), bk=bk, bm=bm)
    p = sformat.from_ternary(torch.from_numpy(t), torch.from_numpy(scale), bk=bk, bm=bm)
    return j, p


@pytest.mark.parametrize("p_dead", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("k,m,bk,bm", [(200, 130, 64, 64), (256, 256, 64, 64),
                                       (136, 100, 64, 32), (300, 200, 128, 128)])
def test_from_ternary_byte_equal_to_reference(k, m, bk, bm, p_dead):
    t, scale = _block_sparse(k, m, bk, bm, p_dead, seed=k + m)
    j, p = _compact_both(t, scale, bk, bm)
    _assert_same(p, j, FIELDS)
    assert (p.n_live, p.s_max, p.shape, p.block_shape) == \
        (j.n_live, j.s_max, j.shape, j.block_shape)
    assert p.nbytes() == j.nbytes() and p.block_density == j.block_density
    assert sformat.strip_schedule(p)[3] == jformat.strip_schedule(j)[3]
    if p_dead == 1.0:      # one slot that decodes to zeros, an empty walk
        assert p.n_live == 0 and p.sign_pool.shape[0] == 1 and p.kids.shape[1] == 1
        assert bool((p.zero_pool == 0xFF).all()) and int(p.counts.sum()) == 0


def test_from_ternary_takes_a_measured_occupancy_grid():
    t, scale = _block_sparse(200, 130, 64, 64, 0.5, seed=1)
    occ = stats.block_occupancy(torch.from_numpy(t), 64, 64)
    a = sformat.from_ternary(torch.from_numpy(t), torch.from_numpy(scale), 64, 64,
                             occupancy=occ)
    _, p = _compact_both(t, scale, 64, 64)
    _assert_same(a, p, FIELDS)
    with pytest.raises(ValueError, match="occupancy grid"):
        sformat.from_ternary(torch.from_numpy(t), None, 64, 64, occupancy=occ[:1])


@pytest.mark.parametrize("p_dead", [0.0, 0.5, 1.0])
def test_round_trips_and_format_conversions_match_reference(p_dead):
    t, scale = _block_sparse(200, 130, 64, 64, p_dead, seed=7)
    j, p = _compact_both(t, scale, 64, 64)
    np.testing.assert_array_equal(sformat.to_ternary(p).numpy(), t)
    tw = sformat.to_packed(p)
    want = ternary.pack(torch.from_numpy(t), torch.from_numpy(scale))
    assert torch.equal(tw.sign_plane, want.sign_plane)
    assert torch.equal(tw.zero_plane, want.zero_plane)
    # compacted -> padded (tight by default) -> compacted, both packages
    _assert_same(sformat.pad_pool(p), jformat.pad_pool(j), PADDED_FIELDS)
    _assert_same(sformat.pad_pool(p, max_live=40, s_steps=4),
                 jformat.pad_pool(j, max_live=40, s_steps=4), PADDED_FIELDS)
    _assert_same(sformat.compact(sformat.pad_pool(p)), j, FIELDS)
    jpad = jformat.pad_from_ternary(jnp.asarray(t), jnp.asarray(scale), bk=64, bm=64)
    ppad = sformat.pad_from_ternary(torch.from_numpy(t), torch.from_numpy(scale), 64, 64)
    _assert_same(sformat.compact(ppad), jformat.compact(jpad), FIELDS)
    # from the dense planes
    _assert_same(sformat.from_packed(want, 64, 64), j, FIELDS)
    _assert_same(sformat.pad_from_packed(want, 64, 64), jpad, PADDED_FIELDS)


def test_random_block_sparse_ternary_kills_whole_blocks():
    g = torch.Generator().manual_seed(3)
    t = sformat.random_block_sparse_ternary(g, (320, 256), 64, 64, p_zero_block=0.5)
    assert t.shape == (320, 256) and t.dtype == torch.int8
    occ = stats.block_occupancy(t, 64, 64)
    live = occ > 0
    assert 0 < int(live.sum()) < live.numel()
    # live blocks carry the unstructured ~1/3 zeros, dead ones none at all
    assert float(occ[live].mean()) == pytest.approx(2 / 3, abs=0.05)


CASES = {
    # name: (K, M, p_dead, dead_strip, block)
    "ragged": (200, 130, 0.5, False, 64),
    "dead_strip": (200, 130, 0.5, True, 64),
    "all_dead": (256, 192, 1.0, False, 64),
    "dense": (300, 200, 0.0, False, 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [1, 4, 33])
def test_compact_sparse_matmul_bit_exact(n, case):
    k, m, p_dead, dead_strip, blk = CASES[case]
    t, scale = _block_sparse(k, m, blk, blk, p_dead, seed=n + k, dead_strip=dead_strip)
    j, p = _compact_both(t, scale, blk, blk)
    if dead_strip:
        assert int(p.counts[0]) == 0
    x = (np.random.default_rng(n).standard_normal((n, k)) * 2).astype(np.float32)
    xt = torch.from_numpy(x)
    got = ops.tsar_sparse_matmul(xt, p).numpy()
    want = np.asarray(jops.tsar_sparse_matmul(jnp.asarray(x), j, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jref.block_sparse_matmul_ref(
        jnp.asarray(x), j)))
    np.testing.assert_array_equal(got, ref.block_sparse_matmul_ref(xt, p).numpy())
    dense = ops.tsar_matmul(xt, ternary.pack(torch.from_numpy(t), torch.from_numpy(scale)))
    np.testing.assert_array_equal(got, dense.numpy())


def test_compact_counter_is_apart_and_untouched_on_cpu():
    assert set(ts.LAUNCHES) == {"tsar_sparse", "tsar_sparse_padded"}
    t, scale = _block_sparse(200, 130, 64, 64, 0.5, seed=5)
    _, p = _compact_both(t, scale, 64, 64)
    before = dict(ts.LAUNCHES)
    x = np.random.default_rng(0).standard_normal((2, 3, 200)).astype(np.float32)
    got = ops.tsar_sparse_matmul(torch.from_numpy(x), p)
    assert got.shape == (2, 3, 130)
    assert ts.LAUNCHES == before
    assert ts.tsar_sparse_compact_plain is ts.tsar_sparse_padded_plain


@pytest.mark.gpu
def test_cuda_compact_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dev = torch.device("cuda")
    # (N, K, M, bk, bm, dead fraction): serving shapes with strip 0 empty,
    # N = 33, an all-dead matrix (one pad slot, every count 0), (64, 36)
    # blocks, (40, 36) blocks with a ragged Kp and (512, 128) blocks.
    for n, k, m, bk, bm, p_dead in [(4, 2560, 6912, 256, 256, 0.5),
                                    (20, 6912, 2560, 256, 256, 0.5),
                                    (33, 200, 132, 64, 64, 0.5), (4, 512, 256, 64, 64, 1.0),
                                    (4, 256, 144, 64, 36, 0.5), (33, 200, 100, 40, 36, 0.5),
                                    (9, 2600, 700, 512, 128, 0.5)]:
        t, scale = _block_sparse(k, m, bk, bm, p_dead, seed=n, dead_strip=True)
        p = sformat.from_ternary(torch.from_numpy(t).to(dev),
                                 torch.from_numpy(scale).to(dev), bk=bk, bm=bm)
        x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, k))
                             .astype(np.float32)).to(dev)
        got = ops.tsar_sparse_matmul(x, p)
        want = ref.block_sparse_matmul_ref(x, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, k, m, bk, bm)
        assert torch.equal(ops.tsar_sparse_matmul(x, p), got), (n, k, m, bk, bm)
