"""Port vs reference: ``core.bitlinear`` (freeze, kernel resolution,
``apply_frozen`` through all six registry kernels, the eval and QAT
forwards) and ``compile_plan`` over ``FrozenBitLinear`` layers.

The same numpy-seeded latent weights and activations go through
``repro.core.bitlinear`` and ``repro_torch.core.bitlinear``:

* ``freeze`` gives byte-equal planes, LUT indices, compacted and padded
  pools and walks; the densities agree to rtol 1e-6 (float32 means that
  XLA and torch sum in other orders);
* with the reference's TPU constants patched into the port's cost model,
  ``resolve_kernel`` and ``compile_plan`` name the same kernels and the
  same estimated times;
* ``apply_frozen`` is bit-exact for the int8 family (``tsar_mxu``,
  ``tsar_sparse``, ``tsar_sparse_padded``) and within rtol 1e-4 / atol 2e-3
  for the float family (``tsar_lut``, ``memory_lut``, ``dense``) against
  the reference's own ``apply_frozen`` (its jnp spelling); bf16 within
  rtol 2e-2 / atol 2e-1, the reference's bf16 conformance tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitlinear as jbl
from repro.core import dataflow as jdataflow
from repro.core import hw as jhw
from repro.plan import BatchProfile as JBatchProfile
from repro.plan import compile_plan as jcompile_plan
from repro.plan.plan import LayerPlan as JLayerPlan
from repro_torch import bridge
from repro_torch.core import bitlinear, dataflow, hw
from repro_torch.plan import BatchProfile, LayerPlan, ModelPlan, compile_plan, registry

INT8_FAMILY = ("tsar_mxu", "tsar_sparse", "tsar_sparse_padded")
FP_FAMILY = ("tsar_lut", "memory_lut", "dense")
BLOCK = (64, 64)
# name: (K, M, live-block fraction of the latent weights)
LAYERS = {"dense": (200, 130, 1.0), "third": (256, 192, 1 / 3),
          "most": (320, 320, 0.95), "empty": (128, 128, 0.0)}


@pytest.fixture
def tpu_constants(monkeypatch):
    """The port's hw module with the reference's constants patched in."""
    for name in ("PEAK_FLOPS_BF16", "PEAK_FLOPS_INT8", "HBM_BW"):
        monkeypatch.setattr(hw, name, getattr(jhw, name))


def _latent(k, m, live, seed=0):
    """Latent (K, M) float32 weights with a seeded fraction of (64, 64)
    blocks zeroed (block (0, 0) always live unless ``live`` is 0)."""
    rng = np.random.default_rng(seed + k + m)
    w = (rng.standard_normal((k, m)) / np.sqrt(k)).astype(np.float32)
    kb, mb = -(-k // BLOCK[0]), -(-m // BLOCK[1])
    alive = rng.random((kb, mb)) < live
    alive[0, 0] = live > 0
    w *= np.repeat(np.repeat(alive, BLOCK[0], 0), BLOCK[1], 1)[:k, :m]
    return w


def _x(n, k, seed=1):
    return np.random.default_rng(seed + n).standard_normal((n, k)).astype(np.float32)


def _freeze_both(name, **kw):
    k, m, live = LAYERS[name]
    w = _latent(k, m, live)
    jfz = jbl.freeze({"w": jnp.asarray(w)}, block_shape=BLOCK, **kw)
    fz = bitlinear.freeze({"w": torch.from_numpy(w)}, block_shape=BLOCK, **kw)
    return jfz, fz


def _bytes_equal(got, want, fields):
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


POOL = ("sign_pool", "zero_pool", "block_map", "kids", "slots", "counts")


@pytest.mark.parametrize("padded", [None, True, False])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_freeze_byte_equal_to_reference(name, padded):
    jfz, fz = _freeze_both(name, padded=padded)
    _bytes_equal(fz.packed, jfz.packed, ("sign_plane", "zero_plane"))
    np.testing.assert_allclose(fz.packed.scale.numpy(), np.asarray(jfz.packed.scale),
                               rtol=1e-6, atol=1e-12)
    _bytes_equal(fz, jfz, ("idx_pos", "idx_zero"))
    assert fz.c == jfz.c == bitlinear.DEFAULT_C and fz.shape == tuple(jfz.shape)
    assert fz.density == pytest.approx(jfz.density, rel=1e-6)
    assert fz.block_density == pytest.approx(jfz.block_density, rel=1e-6)
    assert (fz.sparse is None) == (jfz.sparse is None)
    assert (fz.padded is None) == (jfz.padded is None)
    if fz.sparse is not None:
        _bytes_equal(fz.sparse, jfz.sparse, POOL + ("occupancy",))
        assert (fz.sparse.n_live, fz.sparse.s_max) == (jfz.sparse.n_live, jfz.sparse.s_max)
    if fz.padded is not None:
        _bytes_equal(fz.padded, jfz.padded, POOL)
        assert (fz.padded.max_live, fz.padded.s_steps) == \
            (jfz.padded.max_live, jfz.padded.s_steps)
    # the threshold: sidecars only below 0.95 live blocks
    assert (fz.sparse is not None) == (fz.block_density < bitlinear.SPARSE_SIDE_CAR_THRESHOLD)
    assert bitlinear.SPARSE_SIDE_CAR_THRESHOLD == jbl.SPARSE_SIDE_CAR_THRESHOLD


def test_freeze_padded_bounds_pass_through():
    w = _latent(256, 192, 1 / 3)
    jfz = jbl.freeze({"w": jnp.asarray(w)}, block_shape=BLOCK, max_live=20, s_steps=4)
    fz = bitlinear.freeze({"w": torch.from_numpy(w)}, block_shape=BLOCK,
                          max_live=20, s_steps=4)
    _bytes_equal(fz.padded, jfz.padded, POOL)
    assert fz.padded.max_live == 20 and fz.padded.s_steps == 4


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_resolve_kernel_matches_reference(name, tpu_constants):
    jfz, fz = _freeze_both(name)
    for n in (1, 4, 20, 128):
        assert bitlinear.resolve_kernel(fz, n) == jbl.resolve_kernel(jfz, n), (name, n)
        assert bitlinear.resolve_kernel(fz, n, "auto") == jbl.resolve_kernel(jfz, n, "auto")


def test_auto_names_the_compacted_kernel_on_a_sparse_layer():
    """Under the port's own H100 constants a layer with a third of its blocks
    live resolves to the compacted kernel, whose cost is strictly below the
    padded one's."""
    _, fz = _freeze_both("third")
    assert fz.sparse is not None and fz.padded is not None
    for n in (1, 4, 20):
        assert bitlinear.resolve_kernel(fz, n) == "tsar_sparse"


def test_degrade_rule_and_explicit_name_raise():
    _, fz = _freeze_both("third")
    jfz, _ = _freeze_both("third")
    lp = LayerPlan("tsar_sparse", "AP", (), 1e-6, "memory", 0.5)
    jlp = JLayerPlan("tsar_sparse", "AP", (), 1e-6, "memory", 0.5)
    cases = [(fz._replace(sparse=None), jfz._replace(sparse=None), "tsar_sparse_padded"),
             (fz._replace(padded=None), jfz._replace(padded=None), "tsar_sparse"),
             (fz._replace(sparse=None, padded=None),
              jfz._replace(sparse=None, padded=None), "tsar_mxu")]
    for mine, theirs, want in cases:
        assert bitlinear.resolve_kernel(mine, 4, lp) == want
        assert jbl.resolve_kernel(theirs, 4, jlp) == want
    lp_pad = LayerPlan("tsar_sparse_padded", "AP", (), 1e-6, "memory", 0.5)
    assert bitlinear.resolve_kernel(fz._replace(padded=None), 4, lp_pad) == "tsar_sparse"
    x = torch.from_numpy(_x(4, 256))
    y = bitlinear.apply_frozen(fz._replace(sparse=None, padded=None), x, plan=lp)
    np.testing.assert_array_equal(
        y.numpy(), bitlinear.apply_frozen(fz, x, plan="tsar_mxu").numpy())
    # an explicit name is taken as asked, and a missing format raises
    assert bitlinear.resolve_kernel(fz._replace(sparse=None), 4, "tsar_sparse") == \
        "tsar_sparse"
    with pytest.raises(ValueError, match="block-sparse sidecar"):
        bitlinear.apply_frozen(fz._replace(sparse=None), x, plan="tsar_sparse")
    with pytest.raises(ValueError, match="block-sparse sidecar"):
        jbl.apply_frozen(jfz._replace(sparse=None), jnp.asarray(x.numpy()),
                         plan="tsar_sparse")


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("kernel", sorted(INT8_FAMILY + FP_FAMILY))
@pytest.mark.parametrize("name", ["third", "dense"])
def test_apply_frozen_matches_reference(name, kernel, n):
    # The reference's freeze carried across: ``freeze`` itself is held
    # byte-equal above, but its float32 scales may differ in the last bit.
    jfz, _ = _freeze_both(name, padded=True)
    if jfz.sparse is None:      # the dense layer: give it a compacted sidecar too
        from repro.sparse import format as jformat

        jfz = jfz._replace(sparse=jformat.from_packed(jfz.packed, *BLOCK))
    fz = bridge.frozen_from_reference(jfz, device="cpu")
    x = _x(n, LAYERS[name][0])
    got = bitlinear.apply_frozen(fz, torch.from_numpy(x), plan=kernel)
    want = np.asarray(jbl.apply_frozen(jfz, jnp.asarray(x), plan=kernel))
    assert got.dtype == torch.float32 and got.shape == want.shape
    if kernel in INT8_FAMILY:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("kernel", sorted(INT8_FAMILY + FP_FAMILY))
def test_apply_frozen_bf16_returns_bf16(kernel):
    jfz, fz = _freeze_both("third")
    x = _x(4, LAYERS["third"][0])
    got = bitlinear.apply_frozen(fz, torch.from_numpy(x).to(torch.bfloat16), plan=kernel)
    assert got.dtype == torch.bfloat16
    want = jbl.apply_frozen(jfz, jnp.asarray(x).astype(jnp.bfloat16), plan=kernel)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=2e-2, atol=2e-1)


def test_apply_frozen_auto_and_leading_dims():
    jfz, _ = _freeze_both("third")
    fz = bridge.frozen_from_reference(jfz, device="cpu")
    x = _x(6, LAYERS["third"][0]).reshape(2, 3, -1)
    got = bitlinear.apply_frozen(fz, torch.from_numpy(x))
    assert got.shape == (2, 3, LAYERS["third"][1])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbl.apply_frozen(jfz, jnp.asarray(x))))
    np.testing.assert_array_equal(
        bitlinear.apply(fz, torch.from_numpy(x)).numpy(), got.numpy())


def test_apply_eval_and_train_forward_match_reference():
    w = _latent(200, 130, 1.0)
    x = _x(5, 200)
    jp, tp = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}
    # Both ternarize the latent weights themselves: the float32 absmean
    # scales are summed in other orders, so they may differ in the last bit.
    np.testing.assert_allclose(
        bitlinear.apply_eval(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jbl.apply_eval(jp, jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        bitlinear.apply(tp, torch.from_numpy(x), train=False).numpy(),
        np.asarray(jbl.apply(jp, jnp.asarray(x), train=False)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        bitlinear.apply_train(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jbl.apply_train(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_apply_train_gradient_is_identity_through_both_quantizers():
    w = _latent(128, 64, 1.0)
    x = _x(8, 128)
    g = np.random.default_rng(9).standard_normal((8, 64)).astype(np.float32)

    def jloss(w, x):
        return jnp.sum(jbl.apply_train({"w": w}, x) * jnp.asarray(g))

    jgw, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    tw = torch.from_numpy(w).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    (bitlinear.apply_train({"w": tw}, tx) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    # identity STE: d/dw sum(2 * ste(w)) == 2
    w2 = torch.from_numpy(w).requires_grad_()
    (2.0 * bitlinear.ste_ternarize(w2)).sum().backward()
    assert torch.equal(w2.grad, torch.full_like(w2, 2.0))


def test_init_is_fan_in_scaled_on_the_generator_device():
    p = bitlinear.init(torch.Generator().manual_seed(0), 512, 256)
    assert p["w"].shape == (512, 256) and p["w"].dtype == torch.float32
    assert float(p["w"].std()) == pytest.approx(1 / np.sqrt(512), rel=0.05)


def test_compile_plan_over_frozen_layers_matches_reference(tpu_constants):
    pairs = {name: _freeze_both(name) for name in LAYERS}
    profile = dict(decode_ns=(1, 4), prefill_ns=(20,))
    theirs = jcompile_plan({n: j for n, (j, _) in pairs.items()}, JBatchProfile(**profile))
    mine = compile_plan({n: t for n, (_, t) in pairs.items()}, BatchProfile(**profile))
    tj, tm = theirs.to_json(), mine.to_json()
    jd, md = ModelPlan.from_json(tj).layers, ModelPlan.from_json(tm).layers
    assert dict(mine.shapes) == dict(theirs.shapes)
    assert mine.buckets == theirs.buckets and set(md) == set(jd)
    for name, by_n in jd.items():
        for n, lp in by_n.items():
            got = md[name][n]
            assert (got.kernel, got.bound, got.est_time_s) == \
                (lp.kernel, lp.bound, lp.est_time_s), (name, n)
            assert got.density == pytest.approx(lp.density, rel=1e-6)
            assert got.tile_sizes == registry.get(got.kernel).tiles(
                n, *mine.shapes[name])
    # the reference's JSON loads in the port and comes back byte-equal
    assert ModelPlan.from_json(tj).to_json() == tj
    assert mine.kernel_counts(4) == theirs.kernel_counts(4)


def test_layer_plan_matches_reference_kernels(tpu_constants):
    shapes = {"a": (1, 2560, 6912), "b": (128, 2560, 2560, 2),
              "c": {"n": 4, "k": 2560, "m": 640, "block_density": 0.3}}
    mine, theirs = dataflow.layer_plan(shapes), jdataflow.layer_plan(shapes)
    assert set(mine) == set(theirs)
    for name, choice in theirs.items():
        assert (mine[name].kernel, mine[name].est_time_s) == \
            (choice.kernel, choice.est_time_s)
    assert dataflow._tsar_sparse_cost(4, 2560, 640, 0.3) == \
        jdataflow._tsar_sparse_cost(4, 2560, 640, 0.3)
    assert dataflow._tsar_lut_cost(4, 2560, 640, 4) == jdataflow._tsar_lut_cost(4, 2560, 640, 4)
    assert dataflow._tsar_mxu_cost(4, 2560, 640) == jdataflow._tsar_mxu_cost(4, 2560, 640)


def test_frozen_from_reference_carries_every_array_byte_for_byte():
    jfz, _ = _freeze_both("third")
    fz = bridge.frozen_from_reference(jfz, device="cpu")
    _bytes_equal(fz.packed, jfz.packed, ("sign_plane", "zero_plane", "scale"))
    _bytes_equal(fz, jfz, ("idx_pos", "idx_zero"))
    _bytes_equal(fz.sparse, jfz.sparse, POOL + ("occupancy", "scale"))
    _bytes_equal(fz.padded, jfz.padded, POOL + ("occupancy", "scale"))
    assert (fz.density, fz.block_density) == (jfz.density, jfz.block_density)
    assert registry.available(fz) == registry.names()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        if not torch.cuda.is_available():
            bridge.frozen_from_reference(jfz)
        else:
            raise RuntimeError("torch.cuda.is_available() is True here")
