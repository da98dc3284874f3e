"""Port vs reference: the MoE, SSM and hybrid families through the serving
engine, their params trees and the reference's limits.

The reference engine (``packed=True``) freezes each reduced config; the
port's engine serves the same frozen planes, carried across with the
bridge, on the CPU.  On the same requests the step plans, the greedy tokens
and the deterministic counters must be identical (``run_pair`` /
``assert_same_run``): ``deepseek-moe-16b`` under ``flat``, ``chunked`` and
``whole`` at its default capacity and under ``flat`` dropless;
``mamba2-780m`` and ``hymba-1.5b`` under ``whole``, the only policy the
reference allows them; ``llama4-maverick-400b-a17b`` (top-1 routing over
its experts, a shared expert, qk-norm) and the dense ``deepseek-coder-33b``
under ``flat``, with their teacher-forced logits.  The SSM families' prompts are at most the reduced
``ssm_chunk`` (16) or a multiple of it: a whole prefill of any other length
fails in the reference, and in the port (tested below).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import (assert_same_run, port_params, reference_frozen,
                            reference_latent, requests, run_pair)

import repro.configs as jconfigs
from repro.models import model_zoo as jzoo
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.models import model_zoo, transformer
from repro_torch.serving import Request, ServingEngine

MOE, SSM, HYBRID = "deepseek-moe-16b", "mamba2-780m", "hymba-1.5b"
LLAMA4, CODER = "llama4-maverick-400b-a17b", "deepseek-coder-33b"
_KW = dict(max_len=64, batch_slots=2, prefill_chunk=8)
SCENARIOS = {
    # name: (arch, engine kwargs, capacity_factor or None, prompt lengths)
    "moe_flat": (MOE, _KW, None, [3, 8, 21, 40, 5]),
    "moe_chunked": (MOE, dict(_KW, policy="chunked"), None, [3, 8, 21, 40, 5]),
    "moe_whole": (MOE, dict(_KW, policy="whole"), None, [3, 8, 21, 40, 5]),
    "moe_flat_dropless": (MOE, _KW, 8.0, [3, 8, 21, 40, 5]),
    "ssm_whole": (SSM, _KW, None, [3, 8, 16, 32, 5]),
    "hybrid_whole": (HYBRID, _KW, None, [3, 8, 16, 32, 5]),
    # 128 experts top-1 with a shared expert and qk-norm (4 experts reduced);
    # the dense 62-layer coder (2 layers reduced).
    "llama4_flat": (LLAMA4, _KW, None, [3, 8, 21, 40, 5]),
    "coder_flat": (CODER, _KW, None, [3, 8, 21, 40, 5]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_reference(scenario):
    arch, kw, cf, lens = SCENARIOS[scenario]
    cfg = reference_latent(arch)[0]
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    run = run_pair(arch, kw, lambda cls: requests(cls, lens, 5, 7), cfg=cfg)
    assert_same_run(*run)
    port = run[1]
    assert port.policy == kw.get("policy", "flat" if cfg.family in ("dense", "moe")
                                 else "whole")
    if port.policy == "whole":
        assert port.stats["whole_prefills"] == len(lens)


# Logits tolerance per arch: the dense coder at test_torch_policies.py's
# 1e-4; llama4's routed experts are bf16 products (roundoff 2^-8) behind a
# float32 router that XLA and torch round differently, so its logits are
# held at test_torch_moe.py's 1e-2 for the MoE output (max 0.008 over three
# seeds of 2 x 40 tokens), with every argmax equal.
FORWARD_TOL = {LLAMA4: dict(rtol=1e-2, atol=1e-2), CODER: dict(rtol=1e-4, atol=1e-4)}


@pytest.mark.parametrize("arch", sorted(FORWARD_TOL))
def test_forward_matches_reference(arch):
    """Teacher-forced logits of the reduced config on the reference's frozen
    planes (carried across): within the arch's tolerance, argmax equal, the
    MoE aux loss within 1e-6."""
    cfg, frozen = reference_frozen(arch)
    toks = np.random.default_rng(4).integers(0, 500, size=(2, 40)).astype(np.int32)
    want, want_aux = jzoo.forward(cfg, frozen, {"tokens": jnp.asarray(toks)}, train=False)
    got, aux = model_zoo.forward(cfg, port_params(arch), {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (2, 40, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD_TOL[arch])
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", [MOE, SSM, HYBRID])
def test_bridge_carries_family_trees(arch):
    """Every leaf of the reference's frozen tree comes across with its
    shape, dtype and bytes: the 4-D expert planes, the router ``wd``, the
    SSM ``conv_w``, ``A_log``, ``D`` and ``dt_bias``."""
    _, frozen = reference_frozen(arch)
    want = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(frozen)[0]}
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(port_params(arch))[0]}
    assert set(got) == set(want)
    for name, arr in want.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape and t.numpy().dtype == arr.dtype, name
        assert t.numpy().tobytes() == arr.tobytes(), name
    names = set(want)
    if arch == MOE:
        assert want["['blocks']['moe']['w_gate']['sign']"].ndim == 4
        assert "['blocks']['moe']['router']['wd']" in names
    else:
        for leaf in ("conv_w", "A_log", "D", "dt_bias"):
            assert f"['blocks']['ssm']['{leaf}']" in names


@pytest.mark.parametrize("arch", [MOE, SSM, HYBRID])
def test_init_params_layout_matches_reference(arch):
    """The port's ``init_params`` builds the reference's tree: the same
    leaf names, shapes and dtypes (its random numbers differ)."""
    cfg = jconfigs.get(arch).reduced()
    want = jax.eval_shape(lambda k: jzoo.init_params(cfg, k), jax.random.PRNGKey(0))
    got = model_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_g) == set(flat_w)
    for name, v in flat_w.items():
        assert tuple(flat_g[name].shape) == v.shape, name
        assert flat_g[name].dtype == torch.float32 and v.dtype == np.float32, name


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_paged_cache_keeps_state_dense(arch):
    """K/V leaves are pooled, the SSM conv tail and state stay dense with a
    slot axis; the view passes them through and the scatter writes the
    view's tensors back."""
    cfg = jconfigs.get(arch).reduced()
    want = jax.eval_shape(lambda: jzoo.init_paged_cache(cfg, 3, 7, 4))
    pools = model_zoo.init_paged_cache(cfg, 3, 7, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in pools.items()} == {k: v.shape for k, v in want.items()}
    table = np.array([[1, 2], [3, 0], [4, 5]])
    view = model_zoo.gather_cache_view(pools, torch.as_tensor(table))
    assert view["conv"] is pools["conv"] and view["state"] is pools["state"]
    new_state = torch.ones_like(view["state"])
    view["state"] = new_state
    out = model_zoo.scatter_cache_view(pools, model_zoo.first_writers(table, "cpu"), view)
    assert out["state"] is new_state


def test_whole_prefill_past_ssm_chunk_fails_in_both():
    """A 21-token prompt at the reduced ``ssm_chunk`` 16 cannot be prefilled
    whole by either package (the reference asserts ``s % chunk == 0``)."""
    cfg, latent = reference_latent(SSM)
    ref = JServingEngine(cfg, latent, packed=True, **_KW)
    with pytest.raises(AssertionError):
        ref.run(requests(JRequest, [21], 2, 0))
    port = ServingEngine(cfg, port_params(SSM), device="cpu", **_KW)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        port.run(requests(Request, [21], 2, 0))


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_recurrent_families_refuse_flat_and_chunks(arch):
    """As in the reference: the engine refuses ``flat``/``chunked`` for the
    SSM and hybrid families, ``flat_step`` refuses them, and ``chunk_step``
    takes one token per slot."""
    cfg = jconfigs.get(arch).reduced()
    params = port_params(arch)
    for policy in ("flat", "chunked"):
        with pytest.raises(ValueError, match="unsupported for family"):
            ServingEngine(cfg, params, policy=policy, device="cpu", **_KW)
    cache = model_zoo.init_cache(cfg, 2, 16, device="cpu")
    tokens = torch.zeros((2, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="C == 1"):
        transformer.chunk_step(cfg, params, tokens, tokens, cache, torch.zeros(2))
    t1 = torch.zeros((3,), dtype=torch.long)
    with pytest.raises(ValueError, match="rectangular layout"):
        transformer.flat_step(cfg, params, t1, t1, t1, cache, t1[:2])


def test_forward_sums_the_moe_aux_loss(monkeypatch):
    """``forward`` returns the Switch aux loss of every layer summed in
    layer order, a float32 scalar, as the reference's does (each layer's
    aux against the reference's is in ``test_torch_moe.py``)."""
    from repro_torch.models import moe

    cfg = reference_latent(MOE)[0]
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 100, size=(2, 16)))
    per_layer = []
    inner = moe.moe_forward

    def recording(*args):
        y, aux = inner(*args)
        per_layer.append(aux)
        return y, aux

    monkeypatch.setattr(moe, "moe_forward", recording)
    logits, aux = model_zoo.forward(cfg, port_params(MOE), {"tokens": toks})
    assert logits.shape == (2, 16, cfg.padded_vocab) and len(per_layer) == cfg.n_layers
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert float(aux) == float(sum(per_layer, 0.0))
    _, dense_aux = model_zoo.forward(jconfigs.get("bitnet-2b-4t").reduced(),
                                     port_params("bitnet-2b-4t"), {"tokens": toks})
    assert dense_aux == 0.0
