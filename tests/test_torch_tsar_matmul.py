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
    bn, split = tm.launch_config(n, k, m, sm_count=132)
    assert bn >= min(n, 32) and bn % 4 == 0
    chunks = -(-k // 256)
    per = -(-chunks // split)
    assert 1 <= split <= chunks
    assert (split - 1) * per < chunks      # the last split still has work


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for n, k, m in [(4, 2560, 6912), (20, 6912, 2560), (33, 200, 132)]:
        x, t, scale = _problem(n, k, m)
        tw = ternary.pack(torch.from_numpy(t).to(dev), torch.from_numpy(scale).to(dev))
        got = ops.tsar_matmul(torch.from_numpy(x).to(dev), tw)
        want = ref.quantized_matmul_ref(torch.from_numpy(x).to(dev), tw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, k, m)
