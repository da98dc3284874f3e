"""Port vs reference: ternarization, bitplane packing and activation
quantization (``repro_torch.core.ternary`` against ``repro.core.ternary``).

Inputs come from numpy with fixed seeds and go through both packages; the
integer outputs must match bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ternary as jref
from repro_torch.core import ternary as tport


def _ternary(rng, k, m):
    return rng.integers(-1, 2, size=(k, m)).astype(np.int8)


@pytest.mark.parametrize("k,m", [(8, 16), (13, 5), (64, 130), (200, 64)])
def test_pack_matches_reference_bytes(k, m):
    rng = np.random.default_rng(k * 1000 + m)
    t = _ternary(rng, k, m)
    scale = rng.random(m).astype(np.float32)
    want = jref.pack(jnp.asarray(t), jnp.asarray(scale))
    got = tport.pack(torch.from_numpy(t), torch.from_numpy(scale))
    assert got.shape == want.shape == (k, m)
    np.testing.assert_array_equal(got.sign_plane.numpy(), np.asarray(want.sign_plane))
    np.testing.assert_array_equal(got.zero_plane.numpy(), np.asarray(want.zero_plane))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    # Round trip, ragged tail included, equals the reference's unpack.
    np.testing.assert_array_equal(tport.unpack(got).numpy(), t)
    np.testing.assert_array_equal(tport.unpack(got).numpy(), np.asarray(jref.unpack(want)))


def test_ragged_zero_plane_tail_decodes_to_zero():
    """Pad positions past K carry zero-plane bits = 1 (weight 0)."""
    t = -np.ones((13, 4), np.int8)
    tw = tport.pack(torch.from_numpy(t))
    full = tport.decode_planes(tw.sign_plane, tw.zero_plane, 16).numpy()
    np.testing.assert_array_equal(full[:13], t)
    np.testing.assert_array_equal(full[13:], 0)


@pytest.mark.parametrize("shape", [(1, 64), (4, 200), (3, 5, 128)])
def test_quantize_activations_bit_exact(shape):
    rng = np.random.default_rng(sum(shape))
    a = (rng.standard_normal(shape) * 3).astype(np.float32)
    a.flat[0] = 0.0
    q_ref, s_ref = jref.quantize_activations(jnp.asarray(a))
    q, s = tport.quantize_activations(torch.from_numpy(a))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_quantize_rounds_half_to_even():
    # absmax 127 -> scale ~1; 0.5 and 2.5 sit on ties that must go to even.
    a = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    q_ref, _ = jref.quantize_activations(jnp.asarray(a))
    q, _ = tport.quantize_activations(torch.from_numpy(a))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))


@pytest.mark.parametrize("shape", [(64, 32), (2, 96, 48)])
def test_absmean_ternarize_matches_reference(shape):
    """The ternary values (hence the planes) are bit-exact.  The per-channel
    scale is a float32 sum over K, which XLA splits into reduce-window
    passes of its own choosing and torch sums in another order: it agrees to
    within a few float32 ulps (rtol 1e-6), not bit for bit."""
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    t_ref, s_ref = jref.absmean_ternarize(jnp.asarray(w))
    t, s = tport.absmean_ternarize(torch.from_numpy(w))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6, atol=0)


def test_int8_matmul_trap_needs_wider_accumulator():
    """int8 @ int8 on the CPU stays int8 and wraps: the port accumulates in
    a wider type everywhere."""
    a = torch.full((1, 4), 100, dtype=torch.int8)
    b = torch.ones((4, 1), dtype=torch.int8)
    assert (a.to(torch.int32) @ b.to(torch.int32)).item() == 400
    assert (a @ b).dtype == torch.int8
