"""Port vs reference: LUT index packing, the shared-LUT algorithms and the
``tsar_lut`` kernel's plain version.

The same numpy-seeded ternary matrices and activations go through
``repro.core`` and ``repro_torch.core``: ``pack_indices`` must be byte-equal
(ragged K included) and the integer pipelines bit-exact.  The LUT paths are
floating-point: ``build_lut`` and the two ``tsar_lut_matmul`` forms agree
with the reference to rtol 1e-5 / atol 1e-4 (same sums, other orders), and
``repro_torch.kernels.ops.tsar_lut_gemv`` on CPU tensors (the kernel's plain
version) agrees with the reference Pallas kernel in interpret mode and with
the dense oracle within the reference's contract, rtol 1e-4 / atol 2e-3.
The CUDA kernel runs only on the GPU (the ``gpu`` test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import ternary as jternary
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import lut, ternary
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tsar_lut as tl


def _problem(n, k, m, seed=0):
    rng = np.random.default_rng(seed + 7 * n + 13 * k + m)
    x = rng.standard_normal((n, k)).astype(np.float32)
    t = rng.integers(-1, 2, size=(k, m)).astype(np.int8)
    scale = rng.uniform(0.25, 2.0, m).astype(np.float32)
    return x, t, scale


@pytest.mark.parametrize("k", [128, 130, 133])
@pytest.mark.parametrize("c", [2, 4, 8])
def test_pack_indices_byte_equal_with_ragged_k(c, k):
    _, t, _ = _problem(1, k, 24)
    jp, jz = jternary.pack_indices(jnp.asarray(t), c)
    tp, tz = ternary.pack_indices(torch.from_numpy(t), c)
    for got, want in ((tp, jp), (tz, jz)):
        assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    back = ternary.unpack_indices(tp, tz, c, k)
    np.testing.assert_array_equal(back.numpy(), t)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jternary.unpack_indices(jp, jz, c, k)))
    full = ternary.unpack_indices(tp, tz, c)          # pad rows decode to 0
    assert full.shape[0] == -(-k // c) * c and not full[k:].any()


def test_pack_indices_rejects_wide_blocks():
    with pytest.raises(ValueError, match="c must be <= 8"):
        ternary.pack_indices(torch.zeros((16, 4), dtype=torch.int8), 9)


@pytest.mark.parametrize("k", [64, 61])
def test_zero_plane_density_matches_reference(k):
    _, t, _ = _problem(1, k, 40)
    jtw = jternary.pack(jnp.asarray(t))
    tw = ternary.pack(torch.from_numpy(t))
    got = float(ternary.zero_plane_density(tw.zero_plane, k))
    assert got == pytest.approx(float(jternary.zero_plane_density(jtw.zero_plane, k)),
                                rel=1e-6)
    assert got == pytest.approx(np.count_nonzero(t) / t.size, rel=1e-6)


def test_random_ternary_values_and_zero_rate():
    g = torch.Generator().manual_seed(0)
    t = ternary.random_ternary(g, (300, 200), p_zero=0.25)
    assert t.dtype == torch.int8 and set(t.unique().tolist()) == {-1, 0, 1}
    assert abs(float((t == 0).float().mean()) - 0.25) < 0.02
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(t, ternary.random_ternary(g2, (300, 200), p_zero=0.25))


@pytest.mark.parametrize("c", [2, 4])
def test_build_lut_and_lut_matmuls_match_reference(c):
    x, t, scale = _problem(3, 132, 70)
    jp, jz = jternary.pack_indices(jnp.asarray(t), c)
    tp, tz = ternary.pack_indices(torch.from_numpy(t), c)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(lut.build_lut(xt, c).numpy(),
                               np.asarray(jlut.build_lut(xj, c)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lut.block_sums(xt, c).numpy(),
                               np.asarray(jlut.block_sums(xj, c)), rtol=1e-5, atol=1e-5)
    st = torch.from_numpy(scale)
    one = lut.tsar_lut_matmul(xt, tp, tz, c, st).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jlut.tsar_lut_matmul(xj, jp, jz, c, jnp.asarray(scale))),
        rtol=1e-5, atol=1e-4)
    two = lut.tsar_lut_matmul_twolut(xt, tp, tz, c, st).numpy()
    np.testing.assert_allclose(
        two, np.asarray(jlut.tsar_lut_matmul_twolut(xj, jp, jz, c, jnp.asarray(scale))),
        rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(one, two, rtol=1e-5, atol=1e-4)


def test_integer_pipelines_bit_exact_vs_reference():
    x, t, scale = _problem(5, 200, 48)
    xt, tt, st = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(scale)
    xj, tj, sj = jnp.asarray(x), jnp.asarray(t), jnp.asarray(scale)
    np.testing.assert_array_equal(lut.bitlinear_matmul_exact_int(xt, tt, st).numpy(),
                                  np.asarray(jlut.bitlinear_matmul_exact_int(xj, tj, sj)))
    np.testing.assert_array_equal(lut.bitlinear_matmul_fast(xt, tt, st).numpy(),
                                  np.asarray(jlut.bitlinear_matmul_fast(xj, tj, sj)))
    a_q, a_scale = ternary.quantize_activations(xt)
    np.testing.assert_array_equal(
        lut.dense_int8_matmul(a_q, a_scale, tt, st).numpy(),
        np.asarray(jlut.dense_int8_matmul(jnp.asarray(a_q.numpy()),
                                          jnp.asarray(a_scale.numpy()), tj, sj)))
    np.testing.assert_allclose(lut.dense_matmul(xt, tt, st).numpy(),
                               np.asarray(jlut.dense_matmul(xj, tj, sj)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c", [2, 4])
@pytest.mark.parametrize("n,k,m", [(1, 128, 128), (4, 512, 384), (8, 256, 256),
                                   (2, 132, 70)])
def test_plain_tsar_lut_matches_reference_kernel(n, k, m, c):
    x, t, scale = _problem(n, k, m, seed=c)
    jp, jz = jternary.pack_indices(jnp.asarray(t), c)
    tp, tz = ternary.pack_indices(torch.from_numpy(t), c)
    got = ops.tsar_lut_gemv(torch.from_numpy(x), tp, tz, torch.from_numpy(scale), c=c)
    assert got.shape == (n, m) and got.dtype == torch.float32
    want = jops.tsar_lut_gemv(jnp.asarray(x), jp, jz, jnp.asarray(scale), c=c,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.ternary_matmul_ref(jnp.asarray(x), jnp.asarray(t),
                                                        jnp.asarray(scale))),
        rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(
        got.numpy(), ref.ternary_matmul_ref(torch.from_numpy(x), torch.from_numpy(t),
                                            torch.from_numpy(scale)).numpy(),
        rtol=1e-4, atol=2e-3)


def test_leading_batch_dims_and_no_cpu_launch_count():
    x, t, scale = _problem(6, 132, 70)
    tp, tz = ternary.pack_indices(torch.from_numpy(t), 4)
    before = tl.LAUNCHES["tsar_lut"]
    got = ops.tsar_lut_gemv(torch.from_numpy(x).reshape(2, 3, 132), tp, tz,
                            torch.from_numpy(scale))
    assert got.shape == (2, 3, 70)
    assert tl.LAUNCHES["tsar_lut"] == before
    flat = ops.tsar_lut_gemv(torch.from_numpy(x), tp, tz, torch.from_numpy(scale))
    assert torch.equal(got.reshape(6, 70), flat)


@pytest.mark.parametrize("bad", ["dtype", "k", "w_scale", "contiguous", "c"])
def test_wrapper_rejects_malformed_inputs(bad):
    a = torch.zeros((4, 64))
    ip = torch.zeros((16, 8), dtype=torch.uint8)
    iz = ip.clone()
    w_scale = torch.ones(8)
    c = 4
    if bad == "dtype":
        a = a.to(torch.float64)
    elif bad == "k":
        a = torch.zeros((4, 60))
    elif bad == "w_scale":
        w_scale = torch.ones(9)
    elif bad == "contiguous":
        ip = torch.zeros((8, 16), dtype=torch.uint8).T
    else:
        c = 9
    with pytest.raises((TypeError, ValueError)):
        tl.tsar_lut_gemv(a, ip, iz, w_scale, c=c)


@pytest.mark.parametrize("n,k,m,c", [(1, 2560, 640, 4), (4, 2560, 6912, 4),
                                     (20, 6912, 2560, 4), (33, 132, 72, 2),
                                     (32, 64, 8, 8)])
def test_launch_config_fits_shared_memory_and_covers_k(n, k, m, c):
    blocks = -(-k // c)
    blocks += -blocks % (4 // np.gcd(c, 4))           # as pad_for_tma leaves it
    mp = m + -m % 16
    cfg = tl.launch_config(n, blocks, mp, c, sm_count=132)
    assert cfg.bm == 128 and 1 <= cfg.rows <= min(n, 32)
    # One cluster of 1..8 CTAs per output tile, all in one wave of two CTAs
    # per SM.
    tiles = -(-mp // cfg.bm) * -(-n // cfg.rows)
    assert 1 <= cfg.splits <= 8
    assert tiles * cfg.splits <= 2 * 132 or cfg.splits == 1
    # Splits fall on whole warp steps of whole 16-byte activation rows, and
    # every split has blocks: the last one starts inside K.
    granule = max(4, 32 >> c if c <= 5 else 1)
    assert cfg.blocks_per_split % granule == 0 and cfg.stage_blocks % granule == 0
    assert (cfg.splits - 1) * cfg.blocks_per_split < blocks <= cfg.splits * cfg.blocks_per_split
    # No ring stage without blocks; TMA boxes within 256 rows and elements;
    # the CTA within half an SM, under the per-block opt-in of 227 KiB.
    assert 1 <= cfg.stages <= 8 and (cfg.stages - 1) * cfg.stage_blocks < cfg.blocks_per_split
    assert cfg.stage_blocks <= 256 and cfg.stage_blocks * c <= 256
    smem = tl.smem_bytes(c, cfg.rows, cfg.row_groups, cfg.stages, cfg.stage_blocks)
    assert smem <= tl._SMEM_BUDGET <= 227 * 1024
    # Every row of the CTA tile has a warp whose registers hold it.
    assert cfg.row_groups in (1, 2) and cfg.rows_per_warp in (1, 2, 4, 8, 16)
    assert cfg.row_groups * cfg.rows_per_warp >= cfg.rows


@pytest.mark.parametrize("c", [2, 4, 8])
@pytest.mark.parametrize("n,k,m", [(4, 256, 128), (1, 132, 70), (33, 132, 72),
                                   (3, 60, 16), (2, 24, 5)])
def test_tma_padding_keeps_the_product(n, k, m, c):
    """The CUDA wrapper pads blocks so that blocks * c is a multiple of 4
    (zero activations, zero index rows) and M to 16 for TMA: the padded
    columns are cut off, and aligned shapes are not copied."""
    x, t, scale = _problem(n, k, m, seed=c)
    tp, tz = ternary.pack_indices(torch.from_numpy(t), c)
    blocks = tp.shape[0]
    xt = torch.nn.functional.pad(torch.from_numpy(x), (0, blocks * c - k))
    st = torch.from_numpy(scale)
    padded = tl.pad_for_tma(xt, tp, tz, st, c)
    pa, pp, pz, pw = padded
    assert (pp.shape[0] * c) % 4 == 0 and pp.shape[1] % 16 == 0 and pp.shape == pz.shape
    assert pa.shape == (n, pp.shape[0] * c) and pw.shape == (pp.shape[1],)
    if (blocks * c) % 4 == 0 and m % 16 == 0:
        assert all(p is q for p, q in zip(padded, (xt, tp, tz, st)))
    want = tl.tsar_lut_plain(xt, tp, tz, st, c)
    got = tl.tsar_lut_plain(pa, pp, pz, pw, c)[:, :m]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_lut_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for n, k, m, c in [(4, 2560, 6912, 4), (20, 6912, 2560, 4), (33, 132, 70, 2),
                       (1, 2560, 2560, 1), (4, 2560, 2560, 5), (20, 2560, 2560, 8)]:
        x, t, scale = _problem(n, k, m)
        tp, tz = ternary.pack_indices(torch.from_numpy(t).to(dev), c)
        xs, ss = torch.from_numpy(x).to(dev), torch.from_numpy(scale).to(dev)
        got = ops.tsar_lut_gemv(xs, tp, tz, ss, c=c)
        want = lut.tsar_lut_matmul(xs, tp, tz, c, ss)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)
        # Deterministic: every sum in a fixed order, no atomics.
        assert torch.equal(ops.tsar_lut_gemv(xs, tp, tz, ss, c=c), got)
