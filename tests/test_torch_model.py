"""Port vs reference: the params bridge, freezing, the layers the flat step
uses, and one whole ``flat_step`` of the reduced ``bitnet-2b-4t``.

Weights are made and frozen by the reference package and carried across
with ``repro_torch.bridge.params_from_reference``, so both packages run the
same 2-bit planes.  ``flat_step`` logits agree within rtol/atol 1e-4: the
packed projections are bit-exact, but float32 rmsnorm, softmax and rope
round differently in XLA and torch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.serving.engine import freeze_params as jfreeze
from repro_torch import bridge
from repro_torch.models import layers, model_zoo
from repro_torch.serving import freeze_params


@pytest.fixture(scope="module")
def ref_model():
    cfg = jconfigs.get("bitnet-2b-4t").reduced()
    latent = jzoo.init_params(cfg, jax.random.PRNGKey(0))
    frozen = jfreeze(latent)
    return cfg, latent, frozen


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_bridge_carries_frozen_tree_leaf_for_leaf(ref_model):
    _, _, frozen = ref_model
    ref = dict(_leaves(_np_tree(frozen)))
    got = dict(_leaves(bridge.params_from_reference(_np_tree(frozen), device="cpu")))
    assert set(got) == set(ref)
    assert not any("sp_" in k for k in ref), "reference froze sparse pools"
    for name, arr in ref.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape, name
        assert t.numpy().dtype == arr.dtype, name
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)
    planes = [k for k in ref if k.endswith("/sign") or k.endswith("/zero")]
    assert len(planes) == 14   # 7 projections x {sign, zero}, stacked over L
    for k in planes:
        assert got[k].dtype == torch.uint8
        assert got[k].numpy().tobytes() == ref[k].tobytes()


def test_bridge_carries_sparse_pool_leaves():
    """Padded-pool leaves (``freeze_params(sparse=...)``) come across byte for
    byte with their stacked ``L`` axis."""
    latent = {"w_up": {"w": jax.random.normal(jax.random.PRNGKey(3), (2, 128, 128))}}
    frozen = _np_tree(jfreeze(latent, sparse=True, block_shape=(64, 64)))
    got = bridge.params_from_reference(frozen, device="cpu")["w_up"]
    assert set(got) == {"sign", "zero", "scale", "density", "sp_sign", "sp_zero",
                        "sp_map", "sp_kids", "sp_slots", "sp_counts", "block_density"}
    for name, arr in frozen["w_up"].items():
        assert got[name].shape[0] == 2, name
        assert got[name].numpy().dtype == arr.dtype, name
        assert got[name].numpy().tobytes() == arr.tobytes(), name


def test_bridge_defaults_to_cuda_and_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_reference({"g": np.ones(2, np.float32)})


def test_freeze_matches_reference_planes(ref_model):
    """The port's freeze of the same latent weights gives the same planes
    byte for byte (the scale to a few float32 ulps, see
    test_torch_ternary.py)."""
    _, latent, frozen = ref_model
    mine = dict(_leaves(freeze_params(
        bridge.params_from_reference(_np_tree(latent), device="cpu"))))
    ref = dict(_leaves(_np_tree(frozen)))
    assert set(mine) == set(ref)
    for name, arr in ref.items():
        if name.endswith(("/sign", "/zero", "/density")):
            np.testing.assert_array_equal(mine[name].numpy(), arr, err_msg=name)
        else:
            np.testing.assert_allclose(mine[name].numpy(), arr, rtol=1e-6, atol=0,
                                       err_msg=name)


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, 4, 32)).astype(np.float32)
    g = (rng.standard_normal(32) * 0.1).astype(np.float32)
    pos = np.array([0, 1, 2, 7, 30, 31], np.int32)
    np.testing.assert_allclose(
        layers.rmsnorm({"g": torch.from_numpy(g)}, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.rmsnorm({"g": jnp.asarray(g)}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=1e-5, atol=1e-5)


def _step_inputs(cfg):
    """Two slots on a (2, 2)-block table: slot 0 continues at position 3
    over a pre-filled cache, slot 1 prefills from 0, two padding rows."""
    rng = np.random.default_rng(9)
    n_blocks, bs = 5, 16
    shape = (cfg.n_layers, n_blocks, bs, cfg.n_kv_heads, cfg.head_dim)
    pools = {k: (rng.standard_normal(shape) * 0.5).astype(np.float32) for k in ("k", "v")}
    table = np.array([[1, 2], [3, 4]], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
    slot = np.array([0] * 6 + [1] * 4 + [2, 2], np.int32)
    pos = np.array(list(range(3, 9)) + list(range(4)) + [0, 0], np.int32)
    emit_row = np.array([5, 9], np.int32)
    return pools, table, tokens, slot, pos, emit_row


def test_flat_step_matches_reference(ref_model):
    cfg, _, frozen = ref_model
    pools, table, tokens, slot, pos, emit_row = _step_inputs(cfg)

    jview = jzoo.gather_cache_view({k: jnp.asarray(v) for k, v in pools.items()},
                                   jnp.asarray(table))
    jlogits, jnew = jzoo.flat_step(cfg, frozen, jnp.asarray(tokens), jnp.asarray(slot),
                                   jnp.asarray(pos), jview, jnp.asarray(emit_row))
    jpools = jzoo.scatter_cache_view({k: jnp.asarray(v) for k, v in pools.items()},
                                     jnp.asarray(table), jnew)

    params = bridge.params_from_reference(_np_tree(frozen), device="cpu")
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    ttable = torch.from_numpy(table)
    view = model_zoo.gather_cache_view(tpools, ttable)
    logits, new = model_zoo.flat_step(cfg, params, torch.from_numpy(tokens).long(),
                                      torch.from_numpy(slot).long(),
                                      torch.from_numpy(pos).long(), view,
                                      torch.from_numpy(emit_row).long())
    tpools = model_zoo.scatter_cache_view(tpools, ttable, new)

    assert logits.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    assert (logits.argmax(-1).numpy() == np.asarray(jlogits).argmax(-1)).all()
    for k in ("k", "v"):
        np.testing.assert_allclose(tpools[k].numpy(), np.asarray(jpools[k]),
                                   rtol=1e-4, atol=1e-4)


def test_padding_query_rows_stay_finite(ref_model):
    """A padding row (slot sentinel) masks every key: its softmax must be
    finite uniform garbage, never NaN, and must not touch the cache."""
    cfg, _, frozen = ref_model
    params = bridge.params_from_reference(_np_tree(frozen), device="cpu")
    p = {k: v[0] for k, v in params["blocks"]["attn"].items()
         if not isinstance(v, dict)}
    p.update({k: {kk: vv[0] for kk, vv in v.items()}
              for k, v in params["blocks"]["attn"].items() if isinstance(v, dict)})
    cache = {k: torch.zeros((2, 16, cfg.n_kv_heads, cfg.head_dim)) for k in ("k", "v")}
    x = torch.randn((1, 3, cfg.d_model), generator=torch.Generator().manual_seed(0))
    out, new = layers.attention(cfg, p, x, pos=torch.tensor([0, 0, 0]), is_global=True,
                                cache=cache, slot=torch.tensor([2, 2, 2]))
    assert torch.isfinite(out).all()
    assert torch.equal(new["k"], cache["k"]) and torch.equal(new["v"], cache["v"])
