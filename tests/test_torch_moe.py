"""Port vs reference: ``models/moe.py`` on the reduced ``deepseek-moe-16b``.

The reference freezes the params; the port gets layer 0's MoE params over
the bridge.  Inputs are numpy-seeded.  The expert decode is bit-exact; the
routing (top-k indices, the one-hot dispatch, the capacity drops) is equal;
``aux`` agrees within 1e-6 and ``y`` within rtol/atol 1e-2: the router's
float32 matmul and softmax round differently in XLA and torch, and the
expert products are bf16, whose roundoff is 2^-8.  The
reference's routing tensors are read from its own calls (``jax.lax.top_k``
and the dispatch/combine einsums, recorded through monkeypatch); nothing in
the reference changes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import reference_frozen, reference_latent

from repro.models import moe as jmoe
from repro.serving.engine import freeze_params as jfreeze
from repro_torch import bridge
from repro_torch.models import moe
from repro_torch.serving import freeze_params

ARCH = "deepseek-moe-16b"


@pytest.fixture(scope="module")
def moe_layer():
    """(reduced cfg, reference layer-0 MoE params (numpy), the port's)."""
    cfg, frozen = reference_frozen(ARCH)
    ref = jax.tree.map(lambda v: np.asarray(v[0]), frozen["blocks"]["moe"])
    return cfg, ref, bridge.params_from_reference(ref, device="cpu")


class _EinsumRecorder:
    """Stands in for ``jnp`` inside ``repro.models.moe``: every einsum's
    equation and operands are recorded, then computed by ``jnp``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, eq, *ops, **kw):
        self.calls.append((eq, [np.asarray(o.astype(jnp.float32)) for o in ops]))
        return jnp.einsum(eq, *ops, **kw)


def _reference_call(monkeypatch, cfg, p, x):
    """The reference's ``moe_forward`` with its top-k indices, dispatch and
    (bf16) combine tensors."""
    rec = _EinsumRecorder()
    tops = []
    top_k = jax.lax.top_k

    def recording_top_k(g, k):
        out = top_k(g, k)
        tops.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jmoe, "jnp", rec)
    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    y, aux = jmoe.moe_forward(cfg, p, jnp.asarray(x), train=False)
    monkeypatch.undo()
    ops = dict(rec.calls)
    return {"y": np.asarray(y), "aux": float(aux), "topi": tops[0],
            "dispatch": ops["bsec,bsd->becd"][0], "combine": ops["bsec,becd->bsd"][0]}


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(np.float32)


def test_decoded_expert_weights_bit_equal(moe_layer):
    _, ref, port = moe_layer
    for name in ("w_gate", "w_up", "w_down"):
        leaf = ref[name]
        assert leaf["sign"].ndim == 3          # (E, K//8, M) for one layer
        want = jmoe._decode_planes(jnp.asarray(leaf["sign"]), jnp.asarray(leaf["zero"]),
                                   jnp.asarray(leaf["scale"]))
        got = moe._decode_planes(port[name]["sign"], port[name]["zero"], port[name]["scale"])
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want.astype(jnp.float32)), err_msg=name)


def test_expert_ffn_bit_equal(moe_layer):
    """The three bf16 expert products and the bf16 silu chain, on the same
    dispatched tokens, equal the reference's element for element."""
    cfg, ref, port = moe_layer
    xe = np.random.default_rng(1).standard_normal((2, cfg.n_experts, 6, cfg.d_model))
    xe = jnp.asarray(xe.astype(np.float32)).astype(jnp.bfloat16)
    want = jmoe._expert_ffn(cfg, jax.tree.map(jnp.asarray, ref), xe, train=False)
    got = moe._expert_ffn(port, torch.from_numpy(np.array(xe.astype(jnp.float32))).to(
        torch.bfloat16))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_forward_matches_reference(moe_layer, monkeypatch, capacity_factor):
    cfg, ref, port = moe_layer
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    x = _x(cfg, (2, 24), seed=2)
    want = _reference_call(monkeypatch, cfg, jax.tree.map(jnp.asarray, ref), x)
    xt = torch.from_numpy(x)
    route = moe._route(cfg, port, xt)
    y, aux = moe.moe_forward(cfg, port, xt)
    np.testing.assert_array_equal(route["topi"].numpy(), want["topi"])
    disp = route["dispatch"].to(torch.float32).numpy()
    np.testing.assert_array_equal(disp, want["dispatch"])
    k = cfg.moe_top_k
    drops = x.shape[0] * x.shape[1] * k - int(disp.sum())
    assert drops == x.shape[0] * x.shape[1] * k - int(want["dispatch"].sum())
    if capacity_factor < 1:
        assert drops > 0, "capacity 0.25 dropped no token"
    np.testing.assert_allclose(route["combine"].to(torch.bfloat16).to(torch.float32).numpy(),
                               want["combine"], rtol=1e-2, atol=1e-2)
    assert abs(float(aux) - want["aux"]) <= 1e-6
    assert aux.dtype == torch.float32 and aux.ndim == 0
    np.testing.assert_allclose(y.numpy(), want["y"], rtol=1e-2, atol=1e-2)


def test_max_group_regroups_like_reference(moe_layer, monkeypatch):
    """A call row longer than ``MAX_GROUP`` (and a multiple of it) is cut
    into rows of ``MAX_GROUP`` tokens, each with its own capacity window."""
    cfg, ref, port = moe_layer
    monkeypatch.setattr(moe, "MAX_GROUP", 8)
    x = _x(cfg, (1, 16), seed=3)
    whole = moe._route(cfg, port, torch.from_numpy(x))["dispatch"]
    y, _ = moe.moe_forward(cfg, port, torch.from_numpy(x))
    monkeypatch.setattr(jmoe, "MAX_GROUP", 8)
    want = _reference_call(monkeypatch, cfg, jax.tree.map(jnp.asarray, ref), x)
    regrouped = moe._route(cfg, port, torch.from_numpy(x.reshape(2, 8, -1)))["dispatch"]
    assert want["dispatch"].shape == tuple(regrouped.shape) != tuple(whole.shape)
    np.testing.assert_array_equal(regrouped.to(torch.float32).numpy(), want["dispatch"])
    np.testing.assert_allclose(y.numpy(), want["y"], rtol=1e-2, atol=1e-2)


def test_top_k_orders_ties_like_reference():
    gates = np.array([[0.1, 0.3, 0.3, 0.05, 0.3], [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(gates), 3)
    got_v, got_i = moe._top_k(torch.from_numpy(gates), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_freeze_packs_expert_stacks_like_reference():
    """``freeze_params`` packs the stacked (L, E, K, M) expert weights slice
    by slice as the reference's vmapped freeze does: equal planes and
    densities, scales within rtol 1e-6 (absmean's float32 sum over K is
    ordered differently in XLA and torch)."""
    _, latent = reference_latent(ARCH)
    ref = jax.tree.map(np.asarray, jfreeze(latent["blocks"]["moe"]))
    got = freeze_params(bridge.params_from_reference(
        jax.tree.map(np.asarray, latent["blocks"]["moe"]), device="cpu"))
    for name in ("w_gate", "w_up", "w_down"):
        r, g = ref[name], got[name]
        assert set(g) == set(r) and r["sign"].ndim == 4, (name, sorted(r))
        for leaf in ("sign", "zero"):
            assert g[leaf].dtype == torch.uint8
            assert g[leaf].numpy().tobytes() == r[leaf].tobytes(), (name, leaf)
        np.testing.assert_allclose(g["scale"].numpy(), r["scale"], rtol=1e-6)
        np.testing.assert_allclose(g["density"].numpy(), r["density"], rtol=1e-6)
    assert set(got["router"]) == {"wd"}
