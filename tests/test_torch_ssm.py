"""Port vs reference: ``models/ssm.py`` (Mamba-2 SSD) on the reduced
``mamba2-780m``.

The reference inits and freezes one SSM block; the port gets it over the
bridge, so both run the same 2-bit ``in_proj``/``out_proj`` planes.  On
numpy-seeded inputs ``ssd_chunked``, ``ssm_forward`` (segmented with
``initial_state``/``initial_conv`` and whole) and ``ssm_decode_step`` agree
with the reference within 2e-4, the reference's own tolerance for the
segmented forward (``tests/test_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import ssm as jssm
from repro.serving.engine import freeze_params as jfreeze
from repro_torch import bridge
from repro_torch.models import layers, ssm

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def ssm_block():
    """(reduced cfg, reference frozen SSM params (jnp), the port's)."""
    cfg = jconfigs.get("mamba2-780m").reduced()
    ref = jax.tree.map(np.asarray, jfreeze(jssm.init_ssm(jax.random.PRNGKey(1), cfg)))
    return cfg, jax.tree.map(jnp.asarray, ref), bridge.params_from_reference(ref, device="cpu")


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked(with_state):
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 2, 48, 4, 8, 16, 16
    xd, bm, cm = _rand(rng, (b, s, h, p)), _rand(rng, (b, s, n)), _rand(rng, (b, s, n))
    a_dt = -np.abs(_rand(rng, (b, s, h), 0.3))
    init = _rand(rng, (b, h, p, n)) if with_state else None
    want_y, want_f = jssm.ssd_chunked(*(jnp.asarray(a) for a in (xd, a_dt, bm, cm)), chunk,
                                      init_state=None if init is None else jnp.asarray(init))
    got_y, got_f = ssm.ssd_chunked(*(torch.from_numpy(a) for a in (xd, a_dt, bm, cm)), chunk,
                                   init_state=None if init is None else torch.from_numpy(init))
    _close(got_y, want_y)
    _close(got_f, want_f)


def test_ssd_chunk_limit_raises_in_both():
    """A length that is not a multiple of the chunk fails in both packages
    (the reference asserts; the port raises an error of its own)."""
    rng = np.random.default_rng(1)
    args = (_rand(rng, (1, 21, 2, 4)), -np.abs(_rand(rng, (1, 21, 2))),
            _rand(rng, (1, 21, 8)), _rand(rng, (1, 21, 8)))
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*(jnp.asarray(a) for a in args), 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(*(torch.from_numpy(a) for a in args), 16)


def test_ssm_forward_and_segments(ssm_block):
    """The whole forward agrees with the reference; two segments chained
    through ``initial_state``/``initial_conv`` give the whole call's
    outputs and final state."""
    cfg, ref, port = ssm_block
    u = _rand(np.random.default_rng(2), (2, 64, cfg.d_model))
    want_y, want_f = jssm.ssm_forward(cfg, ref, jnp.asarray(u), train=False)
    ut = torch.from_numpy(u)
    y, final = ssm.ssm_forward(cfg, port, ut)
    _close(y, want_y)
    _close(final, want_f)

    split, w = 32, cfg.ssm_conv_width
    y1, state1 = ssm.ssm_forward(cfg, port, ut[:, :split])
    _, xs, bs, cs, _ = ssm._split_in(cfg, layers.linear(port["in_proj"],
                                                        ut[:, split - (w - 1):split]))
    y2, final2 = ssm.ssm_forward(cfg, port, ut[:, split:], initial_state=state1,
                                 initial_conv=torch.cat([xs, bs, cs], dim=-1))
    _close(torch.cat([y1, y2], dim=1), want_y)
    _close(final2, want_f)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), y.numpy(), **TOL)


def test_ssm_decode_step(ssm_block):
    cfg, ref, port = ssm_block
    rng = np.random.default_rng(3)
    u = _rand(rng, (3, 1, cfg.d_model))
    cache = {k: _rand(rng, tuple(v.shape), 0.5) for k, v in
             ssm.init_ssm_cache(cfg, 3, device="cpu").items()}
    want_y, want_c = jssm.ssm_decode_step(cfg, ref, jnp.asarray(u),
                                          jax.tree.map(jnp.asarray, cache), train=False)
    got_y, got_c = ssm.ssm_decode_step(cfg, port, torch.from_numpy(u),
                                       {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(got_y, want_y)
    assert set(got_c) == set(want_c) == {"conv", "state"}
    for k in got_c:
        _close(got_c[k], want_c[k])


def test_decode_continues_forward(ssm_block):
    """A forward over S tokens, then one decode step seeded with its final
    state and conv tail, gives the forward's output at position S (the
    prefill-then-decode contract)."""
    cfg, _, port = ssm_block
    u = torch.from_numpy(_rand(np.random.default_rng(4), (2, 17, cfg.d_model)))
    _, state = ssm.ssm_forward(cfg, port, u[:, :16])
    w = cfg.ssm_conv_width
    _, xs, bs, cs, _ = ssm._split_in(cfg, layers.linear(port["in_proj"], u[:, 16 - (w - 1):16]))
    y, _ = ssm.ssm_decode_step(cfg, port, u[:, 16:17], {
        "conv": torch.cat([xs, bs, cs], dim=-1), "state": state})
    # A 17-token forward is refused (17 % 16 != 0); the forward is causal,
    # so position 16 of a 32-token forward with the same first 17 tokens
    # stands in for it.
    want, _ = ssm.ssm_forward(cfg, port, torch.cat([u, u[:, :15]], dim=1))
    np.testing.assert_allclose(y[:, 0].numpy(), want[:, 16].numpy(), **TOL)


def test_causal_conv_rejects_a_wrong_tail(ssm_block):
    cfg, ref, port = ssm_block
    x = np.zeros((1, 4, 8), np.float32)
    w, b, tail = np.ones((4, 8), np.float32), np.zeros(8, np.float32), np.zeros((1, 2, 8), np.float32)
    with pytest.raises(ValueError, match="conv_width-1"):
        jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), init=jnp.asarray(tail))
    with pytest.raises(ValueError, match="conv_width-1"):
        ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                         init=torch.from_numpy(tail))


def test_init_ssm_layout_matches_reference(ssm_block):
    cfg, ref, _ = ssm_block
    want = jax.eval_shape(lambda k: jssm.init_ssm(k, cfg), jax.random.PRNGKey(0))
    got = ssm.init_ssm(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    flat_w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_g) == set(flat_w)
    for k, v in flat_w.items():
        assert tuple(flat_g[k].shape) == v.shape and flat_g[k].dtype == torch.float32, k
    for k in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(
            jssm.init_ssm(jax.random.PRNGKey(0), cfg)[k]), rtol=1e-6)
