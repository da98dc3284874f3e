"""Port vs reference: the attention branches, the dense entry points and the
engine's three policies.

Weights are made and frozen by the reference and carried across with the
bridge, so both packages run the same 2-bit planes; inputs are numpy-seeded.
Attention outputs, caches and logits agree within rtol/atol 1e-4 with equal
argmax (the packed projections are bit-exact; float32 rmsnorm, softmax and
rope round differently in XLA and torch).  The engines must give equal step
plans, greedy tokens and counters under ``flat``, ``chunked`` and ``whole``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import (assert_same_run, port_params, reference_dense, reference_frozen,
                            requests, run_pair)

from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro_torch import bridge
from repro_torch.models import layers, model_zoo

TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def _same_argmax(got, want):
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def _layer0_attn(arch):
    cfg, frozen = reference_frozen(arch)
    ref = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in frozen["blocks"]["attn"].items()}
    port = {k: {kk: vv[0] for kk, vv in v.items()}
            for k, v in port_params(arch)["blocks"]["attn"].items()}
    return cfg, ref, port


def _attend_both(arch, x, *, flag=True, **kw):
    """One layer-0 attention call in both packages; numpy ``kw`` values go
    to each side as its own arrays (a cache dict as a dict of them)."""
    cfg, ref_p, port_p = _layer0_attn(arch)

    def conv(v, to):
        if isinstance(v, dict):
            return {k: to(a) for k, a in v.items()}
        return to(v) if isinstance(v, np.ndarray) else v

    ref = jlayers.attention(cfg, ref_p, jnp.asarray(x), is_global=flag, train=False,
                            **{k: conv(v, jnp.asarray) for k, v in kw.items()})
    got = layers.attention(cfg, port_p, torch.from_numpy(x), is_global=flag,
                           **{k: conv(v, torch.from_numpy) for k, v in kw.items()})
    return ref, got


def _x(rng, b, s, d=128):
    return rng.standard_normal((b, s, d), dtype=np.float32)


def _cache(rng, b, t):
    return {n: rng.standard_normal((b, t, 2, 32), dtype=np.float32) for n in ("k", "v")}


@pytest.mark.parametrize("arch,flag,n_past,rows", [("bitnet-2b-4t", True, 9, 24),
                                                   ("gemma2-2b", False, 40, 48)])
def test_legacy_decode_branch(arch, flag, n_past, rows):
    """A decode token at ``n_past``; on the local ``gemma2-2b`` layer 40 is
    past the window of 32, so the window drops the first 9 rows."""
    rng = np.random.default_rng(0)
    cache = _cache(rng, 2, rows)
    (r_out, r_c), (p_out, p_c) = _attend_both(
        arch, _x(rng, 2, 1), flag=flag, pos=np.array([n_past]), cache=cache, cache_len=n_past)
    _close(p_out, r_out, "out")
    for n in ("k", "v"):
        _close(p_c[n], r_c[n], n)


@pytest.mark.parametrize("arch,flag", [("bitnet-2b-4t", True), ("gemma2-2b", False)])
def test_chunked_append_branch_nonzero_offsets(arch, flag):
    """Per-slot offsets 0, 5 and 37 (past the window of 32), one slot's rows
    clamped at the end of the view as the reference's slice update is."""
    rng = np.random.default_rng(1)
    lengths = np.array([0, 5, 37, 61])
    pos = lengths[:, None] + np.arange(6)
    (r_out, r_c), (p_out, p_c) = _attend_both(
        arch, _x(rng, 4, 6), flag=flag, pos=pos, cache=_cache(rng, 4, 64), cache_len=lengths)
    _close(p_out, r_out, "out")
    for n in ("k", "v"):
        _close(p_c[n], r_c[n], n)


@pytest.mark.parametrize("arch,flag,causal", [("bitnet-2b-4t", True, True),
                                              ("bitnet-2b-4t", True, False),
                                              ("gemma2-2b", False, True),
                                              ("gemma2-2b", True, True)])
def test_full_branch(arch, flag, causal):
    """Causal, unmasked, windowed (local gemma2 layer, 48 tokens > window
    32) and global; ``return_kv`` gives the rotated K/V."""
    rng = np.random.default_rng(2)
    (r_out, (rk, rv)), (p_out, (pk, pv)) = _attend_both(
        arch, _x(rng, 2, 48), flag=flag, pos=np.arange(48), causal=causal, return_kv=True)
    _close(p_out, r_out, "out")
    _close(pk, rk, "k")
    _close(pv, rv, "v")


@pytest.mark.parametrize("branch", ["full", "chunked"])
def test_query_block_loop(branch, monkeypatch):
    """Above ``Q_CHUNK`` (patched to 8 in both packages) queries are attended
    block by block: the port agrees with the reference and with its own
    single-block result."""
    rng = np.random.default_rng(3)
    x = _x(rng, 2, 32)
    if branch == "full":
        kw = dict(pos=np.arange(32))
    else:
        kw = dict(pos=np.array([4, 9])[:, None] + np.arange(32), cache=_cache(rng, 2, 48),
                  cache_len=np.array([4, 9]))
    _, whole = _attend_both("gemma2-2b", x, flag=False, **kw)
    monkeypatch.setattr(jlayers, "Q_CHUNK", 8)
    monkeypatch.setattr(layers, "Q_CHUNK", 8)
    (r_out, _), (p_out, _) = _attend_both("gemma2-2b", x, flag=False, **kw)
    _close(p_out, r_out, "blocked vs reference")
    torch.testing.assert_close(p_out, whole[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_a_token_gets_the_same_bits_in_any_step_layout(device):
    """rmsnorm and attention give a row the same bits whether it comes alone
    or beside other slots' rows on a wider key axis: slot 0's five tokens in
    a flat step over a (1, 16) view, then with 251 rows of two more slots
    over a (3, 256) view.  This is what keeps greedy tokens equal across the
    policies and cache modes on the card, where float32 reductions reorder
    with the shapes of the call (``tools/layout_probe.py``)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cfg, _, port_p = _layer0_attn("bitnet-2b-4t")
    port_p = {k: {kk: t.to(device) for kk, t in v.items()} for k, v in port_p.items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_x(rng, 1, 256)).to(device)

    def cache(b, t):
        return {n: torch.from_numpy(a).to(device) for n, a in _cache(rng, b, t).items()}

    def ints(seq):
        return torch.tensor(seq, device=device)

    norm = {"g": torch.from_numpy(rng.standard_normal(128, dtype=np.float32)).to(device)}
    assert torch.equal(layers.rmsnorm(norm, x[:, :5]), layers.rmsnorm(norm, x)[:, :5])
    alone, _ = layers.attention(cfg, port_p, x[:, :5], pos=ints(range(5)), is_global=True,
                                cache=cache(1, 16), slot=ints([0] * 5))
    slot = ints([0] * 5 + [1] * 200 + [2] * 51)
    pos = ints(list(range(5)) + list(range(30, 230)) + list(range(51)))
    mixed, _ = layers.attention(cfg, port_p, x, pos=pos, is_global=True, cache=cache(3, 256),
                                slot=slot)
    assert torch.equal(alone[:, :5], mixed[:, :5])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _tokens(rng, b, s):
    return rng.integers(0, 500, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["bitnet-2b-4t", "gemma2-2b"])
def test_forward(arch):
    cfg, frozen = reference_frozen(arch)
    toks = _tokens(np.random.default_rng(4), 2, 40)
    want, aux = jzoo.forward(cfg, frozen, {"tokens": jnp.asarray(toks)}, train=False)
    got, got_aux = model_zoo.forward(cfg, port_params(arch), {"tokens": torch.from_numpy(toks)})
    assert float(aux) == got_aux == 0.0
    _close(got, want, "logits")
    _same_argmax(got, want)


def test_prefill_then_decode_step():
    """``prefill`` of a 40-token prompt into a 48-row cache (last-row logits),
    then three ``decode_step``s at the shared length."""
    cfg, frozen = reference_frozen("bitnet-2b-4t")
    params = port_params("bitnet-2b-4t")
    rng = np.random.default_rng(5)
    toks = _tokens(rng, 2, 40)
    want, r_cache = jzoo.prefill(cfg, frozen, {"tokens": jnp.asarray(toks)},
                                 jzoo.init_cache(cfg, 2, 48))
    got, p_cache = model_zoo.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                                     model_zoo.init_cache(cfg, 2, 48, device="cpu"))
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab)
    _close(got, want, "prefill logits")
    _same_argmax(got, want)
    for t in range(40, 43):
        step = _tokens(rng, 2, 1)
        want, r_cache = jzoo.decode_step(cfg, frozen, jnp.asarray(step), r_cache, t)
        got, p_cache = model_zoo.decode_step(cfg, params, torch.from_numpy(step), p_cache, t)
        _close(got, want, f"decode logits at t={t}")
        _same_argmax(got, want)
    for n in ("k", "v"):
        _close(p_cache[n], r_cache[n], n)


def test_windowed_prefill_and_decode_match_reference():
    """Reduced ``gemma2-2b`` (local layer 0, window 32) on dense weights:
    ``prefill`` of 36 tokens into a 48-row cache, then ``decode_step``s at
    36..39, past the window, against the reference's; logits and caches."""
    cfg, dense = reference_dense("gemma2-2b")
    params = bridge.params_from_reference(dense, device="cpu")
    toks = _tokens(np.random.default_rng(5), 2, 40)
    want, r_cache = jzoo.prefill(cfg, dense, {"tokens": jnp.asarray(toks[:, :36])},
                                 jzoo.init_cache(cfg, 2, 48))
    got, p_cache = model_zoo.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :36])},
                                     model_zoo.init_cache(cfg, 2, 48, device="cpu"))
    _close(got, want, "prefill logits")
    _same_argmax(got, want)
    for t in range(36, 40):
        step = toks[:, t:t + 1]
        want, r_cache = jzoo.decode_step(cfg, dense, jnp.asarray(step), r_cache, t)
        got, p_cache = model_zoo.decode_step(cfg, params, torch.from_numpy(step), p_cache, t)
        _close(got, want, f"decode logits at t={t}")
        _same_argmax(got, want)
    for n in ("k", "v"):
        _close(p_cache[n], r_cache[n], n)


def test_windowed_prefill_and_decode_agree_with_forward():
    """Reduced ``gemma2-2b`` on its frozen 2-bit planes: ``prefill`` of 36
    tokens and ``decode_step``s at 36..39 give the logits the port's own
    ``forward`` gives at those positions, so the decode branch's window
    matches the full branch's.  An extra check beside the reference
    comparison above, which runs dense weights: on planes, a float32
    rounding difference between the packages can move an activation across
    an int8 quantization step (layer 0 of this prompt has two such codes),
    which the rtol/atol 1e-4 comparison cannot absorb."""
    cfg = reference_frozen("gemma2-2b")[0]
    params = port_params("gemma2-2b")
    toks = torch.from_numpy(_tokens(np.random.default_rng(5), 2, 40))
    full, _ = model_zoo.forward(cfg, params, {"tokens": toks})
    got, cache = model_zoo.prefill(cfg, params, {"tokens": toks[:, :36]},
                                   model_zoo.init_cache(cfg, 2, 48, device="cpu"))
    torch.testing.assert_close(got[:, 0], full[:, 35], rtol=1e-5, atol=1e-5)
    for t in range(36, 40):
        got, cache = model_zoo.decode_step(cfg, params, toks[:, t:t + 1], cache, t)
        torch.testing.assert_close(got[:, 0], full[:, t], rtol=1e-5, atol=1e-5)


def test_chunk_step_matches_reference():
    """One rectangular step: a 6-token chunk at offset 10 beside a decode
    token at offset 20 and a padding row."""
    cfg, frozen = reference_frozen("bitnet-2b-4t")
    rng = np.random.default_rng(6)
    cache = {n: rng.standard_normal((cfg.n_layers, 3, 32, 2, 32), dtype=np.float32)
             for n in ("k", "v")}
    lengths = np.array([10, 20, 4])
    pos = lengths[:, None] + np.minimum(np.arange(6), np.array([[5], [0], [0]]))
    toks = _tokens(rng, 3, 6)
    want, r_cache = jzoo.chunk_step(cfg, frozen, jnp.asarray(toks), jnp.asarray(pos),
                                    {n: jnp.asarray(c) for n, c in cache.items()},
                                    jnp.asarray(lengths), train=False)
    got, p_cache = model_zoo.chunk_step(cfg, port_params("bitnet-2b-4t"),
                                        torch.from_numpy(toks), torch.from_numpy(pos),
                                        {n: torch.from_numpy(c) for n, c in cache.items()},
                                        torch.from_numpy(lengths))
    assert tuple(got.shape) == (3, 6, cfg.padded_vocab)
    _close(got, want, "logits")
    _same_argmax(got, want)
    for n in ("k", "v"):
        _close(p_cache[n], r_cache[n], n)


# ---------------------------------------------------------------------------
# The engine under each policy
# ---------------------------------------------------------------------------

_KW = dict(max_len=96, batch_slots=2, prefill_chunk=8)


@pytest.mark.parametrize("policy,prefix", [("chunked", False), ("whole", False),
                                           ("chunked", True), ("whole", True)])
def test_engine_policy_matches_reference(policy, prefix):
    """Equal plans, tokens and counters under the rectangular policies (the
    ``flat`` ones are ``tests/test_torch_engine.py``'s scenarios); ``whole``
    with the prefix cache requested keeps it off (its keys at zero), as the
    reference does."""
    def make(cls):
        reqs = requests(cls, [3, 8, 21, 13], 6, 7)
        system = (np.arange(32, dtype=np.int32) * 7 + 3) % 90   # two full blocks
        for r in reqs:
            r.prompt = np.concatenate([system, r.prompt])
        return reqs

    run = run_pair("bitnet-2b-4t", dict(_KW, policy=policy, prefix_cache=prefix), make)
    assert_same_run(*run)
    port = run[1]
    assert port.policy == policy
    assert (port.stats["whole_prefills"] > 0) == (policy == "whole")
    if prefix:
        assert (port.prefix is None) == (policy == "whole")
        assert (port.stats["prefix_hit_tokens"] > 0) == (policy == "chunked")


def test_policies_give_equal_tokens():
    """Greedy tokens are equal across the three policies of the port."""
    params = port_params("bitnet-2b-4t")
    cfg = reference_frozen("bitnet-2b-4t")[0]
    from repro_torch.serving import Request, ServingEngine

    outs = {policy: [r.out_tokens for r in ServingEngine(
        cfg, params, device="cpu", policy=policy, **_KW).run(
            requests(Request, [3, 8, 21, 40], 6, 7))] for policy in ("flat", "chunked", "whole")}
    assert outs["flat"] == outs["chunked"] == outs["whole"]
