"""Port vs reference: the padded block-sparse format, the sparse kernel's
wrapper, density profiling and the kernel build hash.

The same numpy-seeded ternary matrices go through
``repro.sparse.format.pad_from_ternary`` and the port's: pools, block map
and schedule must be byte-equal.  ``repro_torch.kernels.ops.
tsar_sparse_padded_matmul`` on CPU tensors (the kernel's plain version) is
held bit-exact against the reference Pallas kernel in interpret mode, the
reference oracle, and the port's dense ``tsar_matmul`` on the decoded
matrix.  The CUDA kernel runs only on the GPU (the ``gpu`` test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import format as jformat
from repro.sparse import stats as jstats
from repro_torch.core import ternary
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import tsar_sparse as ts
from repro_torch.sparse import format as sformat
from repro_torch.sparse import stats

POOL_FIELDS = ("sign_pool", "zero_pool", "block_map", "kids", "slots", "counts",
               "occupancy")


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


def _tight_bounds(t, bk, bm):
    live = np.asarray(jstats.block_occupancy(t, bk, bm)) > 0
    return max(int(live.sum()), 1), max(int(live.sum(axis=0).max()), 1)


def _both(t, scale, bk, bm, **kw):
    j = jformat.pad_from_ternary(jnp.asarray(t), jnp.asarray(scale), bk=bk, bm=bm, **kw)
    p = sformat.pad_from_ternary(torch.from_numpy(t), torch.from_numpy(scale),
                                 bk=bk, bm=bm, **kw)
    return j, p


@pytest.mark.parametrize("bounds", ["full", "tight"])
@pytest.mark.parametrize("p_dead", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("k,m,bk,bm", [(200, 130, 64, 64), (256, 256, 64, 64),
                                       (136, 100, 64, 32)])
def test_pad_from_ternary_byte_equal_to_reference(k, m, bk, bm, p_dead, bounds):
    t, scale = _block_sparse(k, m, bk, bm, p_dead, seed=k + m)
    kw = {}
    if bounds == "tight":
        kw["max_live"], kw["s_steps"] = _tight_bounds(t, bk, bm)
    j, p = _both(t, scale, bk, bm, **kw)
    for f in POOL_FIELDS:
        want = np.asarray(getattr(j, f))
        got = getattr(p, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert got.tobytes() == want.tobytes(), f
    assert (p.max_live, p.s_steps, p.shape, p.block_shape) == \
        (j.max_live, j.s_steps, j.shape, j.block_shape)
    assert p.nbytes() == j.nbytes()
    assert int(p.n_live) == int(j.n_live)


@pytest.mark.parametrize("which", ["max_live", "s_steps"])
def test_undersized_bounds_raise_in_both(which):
    t, scale = _block_sparse(256, 256, 64, 64, 0.25, seed=3)
    live, steps = _tight_bounds(t, 64, 64)
    kw = {"max_live": live - 1} if which == "max_live" else {"s_steps": steps - 1}
    with pytest.raises(ValueError, match=which):
        jformat.pad_from_ternary(jnp.asarray(t), jnp.asarray(scale), bk=64, bm=64, **kw)
    with pytest.raises(ValueError, match=which):
        sformat.pad_from_ternary(torch.from_numpy(t), torch.from_numpy(scale),
                                 bk=64, bm=64, **kw)


@pytest.mark.parametrize("p_dead", [0.0, 0.5, 1.0])
def test_padded_round_trips(p_dead):
    t, scale = _block_sparse(200, 130, 64, 64, p_dead, seed=11)
    _, p = _both(t, scale, 64, 64)
    np.testing.assert_array_equal(sformat.padded_to_ternary(p).numpy(), t)
    tw = sformat.padded_to_packed(p)
    want = ternary.pack(torch.from_numpy(t), torch.from_numpy(scale))
    assert torch.equal(tw.sign_plane, want.sign_plane)
    assert torch.equal(tw.zero_plane, want.zero_plane)


CASES = {
    # name: (K, M, p_dead, dead_strip, zero activation rows, zero k-block)
    "ragged": (200, 130, 0.5, False, False, False),
    "dead_strip": (200, 130, 0.5, True, False, False),
    "zero_activations": (256, 192, 0.5, False, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [1, 4, 20, 33])
def test_sparse_padded_matmul_bit_exact(n, case):
    k, m, p_dead, dead_strip, zero_rows, zero_kblock = CASES[case]
    t, scale = _block_sparse(k, m, 64, 64, p_dead, seed=n + k, dead_strip=dead_strip)
    j, p = _both(t, scale, 64, 64)
    if dead_strip:
        assert int(p.counts[0]) == 0
    x = (np.random.default_rng(n).standard_normal((n, k)) * 2).astype(np.float32)
    if zero_rows:
        x[::2] = 0.0
    if zero_kblock:
        x[:, 64:128] = 0.0
    got = ops.tsar_sparse_padded_matmul(torch.from_numpy(x), p).numpy()
    want = np.asarray(jops.tsar_sparse_padded_matmul(jnp.asarray(x), j, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(x), jformat.padded_to_packed(j))))
    np.testing.assert_array_equal(
        got, ref.padded_sparse_matmul_ref(torch.from_numpy(x), p).numpy())
    dense = ops.tsar_matmul(torch.from_numpy(x),
                            ternary.pack(torch.from_numpy(t), torch.from_numpy(scale)))
    np.testing.assert_array_equal(got, dense.numpy())


def test_leading_batch_dims_and_no_cpu_launch_count():
    t, scale = _block_sparse(200, 130, 64, 64, 0.5, seed=5)
    _, p = _both(t, scale, 64, 64)
    x = np.random.default_rng(0).standard_normal((2, 3, 200)).astype(np.float32)
    before = ts.LAUNCHES["tsar_sparse_padded"]
    got = ops.tsar_sparse_padded_matmul(torch.from_numpy(x), p)
    assert got.shape == (2, 3, 130)
    assert ts.LAUNCHES["tsar_sparse_padded"] == before
    flat = ops.tsar_sparse_padded_matmul(torch.from_numpy(x.reshape(6, 200)), p)
    assert torch.equal(got.reshape(6, 130), flat)


@pytest.mark.parametrize("bad", ["dtype", "kp", "counts", "w_scale", "contiguous"])
def test_wrapper_rejects_malformed_inputs(bad):
    a_q = torch.zeros((4, 128), dtype=torch.int8)
    a_scale = torch.ones((4, 1))
    pool = torch.zeros((3, 8, 64), dtype=torch.uint8)
    kids = torch.zeros((2, 2), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    w_scale = torch.ones(128)
    if bad == "dtype":
        kids = kids.long()
    elif bad == "kp":
        a_q = torch.zeros((4, 120), dtype=torch.int8)
    elif bad == "counts":
        counts = torch.zeros(3, dtype=torch.int32)
    elif bad == "w_scale":
        w_scale = torch.ones(130)
    else:
        kids = torch.zeros((2, 2), dtype=torch.int32).T
    with pytest.raises((TypeError, ValueError)):
        ts.tsar_sparse_padded_matmul_packed(a_q, a_scale, pool, pool.clone(), kids,
                                            kids.clone(), counts, w_scale)


@pytest.mark.parametrize("n,bm,mb,s_steps", [(4, 256, 10, 9), (20, 256, 3, 10),
                                             (33, 64, 3, 4), (1, 64, 1, 1)])
def test_launch_config(n, bm, mb, s_steps):
    """The cluster kernel's picks, from shapes only: one wave of at most two
    CTAs per SM (one where a strip's walk is split anyway and the rows take
    more than one n-tile), a cluster of 1..8 CTAs that each can have a walk
    step, the ring within half an SM's shared memory, and TMA boxes of at
    most 256 rows (16-byte multiples along the inner dimension)."""
    bk = bm
    sm = 132
    cfg = ts.launch_config(n, bk, bm, mb, s_steps, sm_count=sm)
    assert cfg.bm == 64
    tiles = mb * -(-bm // cfg.bm) * -(-n // 32)
    assert tiles * cfg.cluster <= (2 if cfg.n_tiles == 1 or 2 * tiles > sm else 1) * sm
    assert 1 <= cfg.cluster <= min(8, s_steps)
    assert 1 <= cfg.n_tiles <= 4 and 8 * cfg.n_tiles >= min(n, 32) > 8 * (cfg.n_tiles - 1)
    assert 1 <= cfg.stages <= 16 and cfg.stage_blocks >= 1
    assert ts.smem_bytes(cfg.n_tiles, bk, cfg.stages, cfg.stage_blocks) <= ts._SMEM_BUDGET
    # No ring chunk the longest share of the walk cannot use.
    walk = -(-s_steps // cfg.cluster) * -(-bk // 256)
    assert cfg.stages * cfg.stage_blocks <= walk
    # TMA boxes: planes (min(bk/8, 32) rows, 64 columns), activations
    # (8 * n_tiles rows, 128 k bytes).
    for rows, inner in ((min(bk // 8, 32), cfg.bm), (8 * cfg.n_tiles, 128)):
        assert 1 <= rows <= 256 and inner <= 256 and inner % 16 == 0


@pytest.mark.parametrize("n,k,m,bk,bm", [(4, 256, 144, 64, 36), (33, 200, 100, 40, 36),
                                         (20, 200, 130, 40, 64), (4, 512, 512, 256, 256)])
def test_tma_padding_keeps_the_product(n, k, m, bk, bm):
    """The CUDA wrapper pads blocks whose bk or bm is not a multiple of 16
    for TMA (zero weights meeting zero activations, zero scales; a ragged
    Kp = kb * bk becomes a multiple of 16): the plain product over the
    padded operands, cut back to bm columns per strip, is the product;
    aligned operands are not copied, and the launch picks do not change."""
    t, scale = _block_sparse(k, m, bk, bm, 0.5, seed=n + k + m)
    _, p = _both(t, scale, bk, bm)
    kb, mb = p.grid
    rng = np.random.default_rng(n)
    a_q = torch.from_numpy(rng.integers(-127, 128, (n, kb * bk), dtype=np.int8))
    a_scale = torch.from_numpy(rng.random((n, 1), dtype=np.float32) + 0.01)
    w_scale = torch.nn.functional.pad(p.scale, (0, mb * bm - m))
    sched = (p.kids, p.slots, p.counts)
    padded = ts.pad_for_tma(a_q, p.sign_pool, p.zero_pool, w_scale)
    pa, ps, pz, pw = padded
    bkp, bmp = 8 * ps.shape[1], ps.shape[2]
    assert bkp % 16 == 0 and bmp % 16 == 0 and ps.shape == pz.shape
    assert pa.shape == (n, kb * bkp)
    if bk % 16 == 0 and bm % 16 == 0:
        assert all(x is y for x, y in zip(padded, (a_q, p.sign_pool, p.zero_pool, w_scale)))
    want = ts.tsar_sparse_padded_plain(a_q, a_scale, p.sign_pool, p.zero_pool, *sched,
                                       w_scale)
    got = ts.tsar_sparse_padded_plain(pa, a_scale, ps, pz, *sched, pw)
    assert torch.equal(got.view(n, mb, bmp)[:, :, :bm].reshape(n, mb * bm), want)
    assert ts.launch_config(n, bk, bm, mb, p.s_steps, 132) == \
        ts.launch_config(n, bk, bmp, mb, p.s_steps, 132)


def test_profile_params_matches_reference():
    rng = np.random.default_rng(2)
    t, _ = _block_sparse(512, 256, 256, 256, 0.5, seed=2)
    stack = np.stack([t, t * (rng.random(t.shape) < 0.5)])
    jt = stack.astype(np.int8)
    sign = np.packbits(jt < 0, axis=1, bitorder="little")
    zero = np.packbits(jt == 0, axis=1, bitorder="little")
    node = {"sign": sign, "zero": zero, "scale": np.ones((2, 256), np.float32)}
    want = jstats.profile_params({"w_up": node})
    got = stats.profile_params({"w_up": {k: torch.from_numpy(v) for k, v in node.items()}})
    assert len(got) == len(want) == 1
    for key in ("path", "shape"):
        assert got[0][key] == want[0][key]
    for key in ("density", "block_density"):
        assert got[0][key] == pytest.approx(want[0][key], rel=1e-12)
    np.testing.assert_array_equal(got[0]["hist"], want[0]["hist"])
    assert stats.summarize(got) == pytest.approx(jstats.summarize(want))
    np.testing.assert_array_equal(stats.block_occupancy(torch.from_numpy(t), 64, 64).numpy(),
                                  jstats.block_occupancy(t, 64, 64))
    assert stats.weight_density(torch.from_numpy(t)) == jstats.weight_density(t)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    (tmp_path / "a.cuh").write_text("// header v1\n")
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n')
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "b.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert {p.name for p in _build._sources("k")} == {"k.cu", "b.cuh", "a.cuh"}
    assert _build._target("k") == first
    (tmp_path / "a.cuh").write_text("// header v2\n")
    assert _build._target("k") != first


def test_repo_kernels_hash_the_shared_header():
    for name in ("tsar_matmul", "tsar_sparse"):
        assert "tsar_common.cuh" in {p.name for p in _build._sources(name)}


@pytest.mark.gpu
def test_cuda_sparse_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dev = torch.device("cuda")
    # (N, K, M, bk, bm, dead fraction): serving shapes with strip 0 empty,
    # N = 33 (two row tiles), an all-dead matrix, (64, 36) blocks (bm padded
    # to 48), (40, 36) blocks with a ragged Kp (200, padded to 240) and
    # (512, 128) blocks (two 256-k chunks a block).
    for n, k, m, bk, bm, p_dead in [(4, 2560, 6912, 256, 256, 0.5),
                                    (20, 6912, 2560, 256, 256, 0.5),
                                    (33, 200, 132, 64, 64, 0.5), (4, 512, 256, 64, 64, 1.0),
                                    (4, 256, 144, 64, 36, 0.5), (33, 200, 100, 40, 36, 0.5),
                                    (9, 2600, 700, 512, 128, 0.5)]:
        t, scale = _block_sparse(k, m, bk, bm, p_dead, seed=n, dead_strip=True)
        p = sformat.pad_from_ternary(torch.from_numpy(t).to(dev),
                                     torch.from_numpy(scale).to(dev), bk=bk, bm=bm)
        x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, k))
                             .astype(np.float32)).to(dev)
        got = ops.tsar_sparse_padded_matmul(x, p)
        want = ref.padded_sparse_matmul_ref(x, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, k, m, bk, bm)
        assert torch.equal(ops.tsar_sparse_padded_matmul(x, p), got), (n, k, m, bk, bm)
