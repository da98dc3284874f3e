"""Port vs reference: the packed-ternary matmul pipeline.

``repro_torch.kernels.ops.tsar_matmul`` on CPU tensors (the kernel's plain
version) is held bit-exact against the reference Pallas kernel in interpret
mode (``repro.kernels.ops.tsar_matmul(..., interpret=True)``) and against
``repro.kernels.ref.quantized_matmul_ref``.  The CUDA kernel itself runs only
on the GPU: the test marked ``gpu`` compares it with the plain version there
and skips on a machine without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jternary
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ternary
from repro_torch.kernels import ops, ref
from repro_torch.kernels import tsar_matmul as tm


def _problem(n, k, m, seed=0):
    rng = np.random.default_rng(seed + 7 * n + 13 * k + m)
    x = (rng.standard_normal((n, k)) * 2).astype(np.float32)
    t = rng.integers(-1, 2, size=(k, m)).astype(np.int8)
    scale = (rng.random(m) + 0.05).astype(np.float32)
    return x, t, scale


def _both(x, t, scale):
    jtw = jternary.pack(jnp.asarray(t), jnp.asarray(scale))
    ttw = ternary.pack(torch.from_numpy(t), torch.from_numpy(scale))
    return jtw, ttw


@pytest.mark.parametrize("m", [64, 130])
@pytest.mark.parametrize("k", [64, 200, 256])
@pytest.mark.parametrize("n", [1, 4, 20, 33])
def test_tsar_matmul_bit_exact_vs_reference(n, k, m):
    x, t, scale = _problem(n, k, m)
    jtw, ttw = _both(x, t, scale)
    got = ops.tsar_matmul(torch.from_numpy(x), ttw).numpy()
    want_oracle = np.asarray(jref.quantized_matmul_ref(jnp.asarray(x), jtw))
    np.testing.assert_array_equal(got, want_oracle)
    np.testing.assert_array_equal(
        ref.quantized_matmul_ref(torch.from_numpy(x), ttw).numpy(), want_oracle)
    want_kernel = np.asarray(jops.tsar_matmul(jnp.asarray(x), jtw, interpret=True))
    np.testing.assert_array_equal(got, want_kernel)


@pytest.mark.parametrize("dataflow", ["AP", "OP"])
def test_dataflow_argument(dataflow):
    x, t, scale = _problem(4, 64, 64)
    _, ttw = _both(x, t, scale)
    base = ops.tsar_matmul(torch.from_numpy(x), ttw)
    assert torch.equal(ops.tsar_matmul(torch.from_numpy(x), ttw, dataflow=dataflow), base)


def test_dataflow_rejects_unknown():
    x, t, scale = _problem(4, 64, 64)
    _, ttw = _both(x, t, scale)
    with pytest.raises(ValueError, match="dataflow"):
        ops.tsar_matmul(torch.from_numpy(x), ttw, dataflow="XY")


def test_leading_batch_dims():
    x, t, scale = _problem(6, 64, 130)
    jtw, ttw = _both(x, t, scale)
    x3 = x.reshape(2, 3, 64)
    got = ops.tsar_matmul(torch.from_numpy(x3), ttw)
    assert got.shape == (2, 3, 130)
    want = np.asarray(jref.quantized_matmul_ref(jnp.asarray(x3), jtw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_and_dense_oracles_agree_with_reference():
    x, t, scale = _problem(4, 200, 64)
    jtw, ttw = _both(x, t, scale)
    np.testing.assert_allclose(
        ref.packed_matmul_ref(torch.from_numpy(x), ttw).numpy(),
        np.asarray(jref.packed_matmul_ref(jnp.asarray(x), jtw)), rtol=1e-5, atol=1e-5)


def test_wrapper_cpu_does_not_count_launches():
    """On CPU tensors the wrapper computes the plain version: no kernel
    launch, so the counter stays put."""
    x, t, scale = _problem(4, 64, 64)
    _, ttw = _both(x, t, scale)
    before = tm.LAUNCHES["tsar_matmul"]
    ops.tsar_matmul(torch.from_numpy(x), ttw)
    assert tm.LAUNCHES["tsar_matmul"] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "scale", "contiguous"])
def test_wrapper_rejects_malformed_inputs(bad):
    a_q = torch.zeros((4, 64), dtype=torch.int8)
    a_scale = torch.ones((4, 1))
    sign = torch.zeros((8, 16), dtype=torch.uint8)
    zero = torch.zeros((8, 16), dtype=torch.uint8)
    w_scale = torch.ones(16)
    if bad == "dtype":
        a_q = a_q.to(torch.int16)
    elif bad == "shape":
        a_q = torch.zeros((4, 72), dtype=torch.int8)
    elif bad == "scale":
        w_scale = torch.ones(15)
    else:
        sign = torch.zeros((16, 8), dtype=torch.uint8).T
    with pytest.raises((TypeError, ValueError)):
        tm.tsar_matmul_packed(a_q, a_scale, sign, zero, w_scale)


@pytest.mark.parametrize("n,k,m", [(4, 2560, 2560), (20, 2560, 640), (4, 6912, 2560),
                                   (20, 2560, 6912), (33, 512, 64), (1, 8, 4)])
def test_launch_config_covers_k_without_empty_splits(n, k, m):
    cfg = tm.launch_config(n, k, m, sm_count=132)
    assert cfg.bm == 64
    # One cluster of 1..8 CTAs per output tile, all in one wave of CTAs.
    tiles = -(-m // cfg.bm) * -(-n // 32)
    assert 1 <= cfg.splits <= 8
    assert tiles * cfg.splits <= 132 or cfg.splits == 1
    # Split boundaries fall on the kernel's 32-k granule and every split
    # has k: the last one starts inside K.
    steps = -(-k // 32)
    per = -(-steps // cfg.splits)
    bounds = [i * per * 32 for i in range(cfg.splits)]
    assert all(b % 32 == 0 for b in bounds) and bounds[-1] < k
    # No ring stage without k, and the ring fits the shared-memory budget.
    assert 1 <= cfg.stages <= 4 and 1 <= cfg.stage_steps <= 64
    assert (cfg.stages - 1) * cfg.stage_steps < per
    assert tm.smem_bytes(cfg.n_tiles, cfg.stages, cfg.stage_steps) <= tm._SMEM_BUDGET
    # N is covered by whole 8-row n-tiles of one 32-row CTA tile.
    assert 1 <= cfg.n_tiles <= 4
    assert 8 * cfg.n_tiles >= min(n, 32) > 8 * (cfg.n_tiles - 1)


@pytest.mark.parametrize("n,k,m", [(4, 2560, 2560), (33, 200, 130), (20, 2576, 2576),
                                   (4, 6928, 80), (1, 8, 4)])
def test_tma_padding_keeps_the_product(n, k, m):
    """The CUDA wrapper pads Kp and M to 16 for TMA: the padded plane rows
    decode to +1 and meet zero activations, the padded columns are cut off,
    aligned shapes are not copied, and the launch picks do not change."""
    rng = np.random.default_rng(n + k + m)
    a_q = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    a_scale = torch.from_numpy(rng.random((n, 1), dtype=np.float32) + 0.01)
    sign, zero = (torch.from_numpy(rng.integers(0, 256, (k // 8, m), dtype=np.uint8))
                  for _ in range(2))
    w_scale = torch.from_numpy(rng.random(m, dtype=np.float32) + 0.01)
    padded = tm.pad_for_tma(a_q, sign, zero, w_scale)
    pa, ps, pz, pw = padded
    assert pa.shape[1] % 16 == 0 and ps.shape[1] % 16 == 0 and ps.shape == pz.shape
    if k % 16 == 0 and m % 16 == 0:
        assert all(p is q for p, q in zip(padded, (a_q, sign, zero, w_scale)))
    want = tm.tsar_matmul_plain(a_q, a_scale, sign, zero, w_scale)
    assert torch.equal(tm.tsar_matmul_plain(pa, a_scale, ps, pz, pw)[:, :m], want)
    assert tm.launch_config(n, k, m, 132) == tm.launch_config(n, pa.shape[1], ps.shape[1], 132)


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dev = torch.device("cuda")
    shapes = [(4, 2560, 6912), (20, 6912, 2560), (33, 200, 132), (33, 200, 130)]
    # Row counts around the 8-row n-tiles and the 32-row CTA tile.
    shapes += [(n, 2560, 6912) for n in (1, 8, 9, 32, 33)]
    # TMA boxes partly past the matrix: M % 64 != 0 and Kp % 32 != 0 (both
    # multiples of 16, so nothing is padded).
    shapes += [(20, 2576, 2576), (4, 6928, 80)]
    for n, k, m in shapes:
        x, t, scale = _problem(n, k, m)
        tw = ternary.pack(torch.from_numpy(t).to(dev), torch.from_numpy(scale).to(dev))
        got = ops.tsar_matmul(torch.from_numpy(x).to(dev), tw)
        want = ref.quantized_matmul_ref(torch.from_numpy(x).to(dev), tw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, k, m)
