"""Port vs reference: the enc-dec (``whisper-tiny``) and VLM
(``llava-next-mistral-7b``) families, from the cross-attention branch to the
serving engine.

Weights are made and frozen by the reference (reduced configs) and carried
across with the bridge, so both packages run the same 2-bit planes; frames,
patches and tokens are numpy-seeded.  Attention outputs, caches and logits
agree within rtol/atol 1e-4 with equal argmax (the packed projections are
bit-exact; float32 rmsnorm, softmax and rope round differently in XLA and
torch).  Where an input runs through hundreds of rows of encoder
quantizations (the 1500-row encoder attention, ``encode``, ``forward``),
such a rounding difference moves an int8 activation code at a tie
somewhere (222 of 192,000 outputs of the 1500-row attention moved by up to
1.5e-4), so those comparisons run the reference's latent weights as dense
``{'wd'}`` projections, and the planes are held to the port's own prefill.
The engines must give equal step plans, greedy tokens and counters under
``whole``, the only policy the reference allows both families
(``assert_same_run``, with its near-tie rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import (assert_same_run, port_params, reference_dense, reference_frozen,
                            reference_latent, requests, run_pair)

import repro.configs as jconfigs
from repro.core import ternary as jternary
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.core import ternary
from repro_torch.models import encdec, layers, model_zoo, transformer
from repro_torch.serving import Request, ServingEngine

ENCDEC, VLM = "whisper-tiny", "llava-next-mistral-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
_KW = dict(max_len=64, batch_slots=2, prefill_chunk=8)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **TOL)


def _same_argmax(got, want):
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def _layer(tree, i=0):
    """Layer ``i`` of a stacked params tree (numpy or torch leaves)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _tokens(rng, b, s, vocab=500):
    return rng.integers(0, vocab, size=(b, s)).astype(np.int32)


def _both(batch):
    """A numpy batch as each package's inputs: (jnp, torch)."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
             for k, v in batch.items()})


def _encdec_batch(cfg, rng, b=2, s=12):
    return {"tokens": _tokens(rng, b, s), "frames": _rand(rng, b, cfg.enc_seq, cfg.d_model)}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_cross_attention_branch():
    """Decoder layer 0's cross-attention: K/V projected from ``kv_x`` (16
    encoder rows), no RoPE, no mask; ``return_kv`` gives them back."""
    cfg, frozen = reference_frozen(ENCDEC)
    ref_p = _layer(frozen["dec_blocks"]["xattn"])
    port_p = _layer(port_params(ENCDEC)["dec_blocks"]["xattn"])
    assert "qn" not in port_p
    rng = np.random.default_rng(0)
    x, kv_x = _rand(rng, 2, 5, cfg.d_model), _rand(rng, 2, cfg.enc_seq, cfg.d_model)
    pos = np.arange(5)
    r_out, (rk, rv) = jlayers.attention(cfg, ref_p, jnp.asarray(x), pos=jnp.asarray(pos),
                                        is_global=True, kv_x=jnp.asarray(kv_x), causal=False,
                                        train=False, return_kv=True)
    p_out, (pk, pv) = layers.attention(cfg, port_p, torch.from_numpy(x),
                                       pos=torch.from_numpy(pos), is_global=True,
                                       kv_x=torch.from_numpy(kv_x), causal=False,
                                       return_kv=True)
    assert tuple(pk.shape) == (2, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
    _close(p_out, r_out, "out")
    _close(pk, rk, "k")
    _close(pv, rv, "v")


def test_encoder_self_attention_at_1500_rows():
    """The encoder's non-causal self-attention at ``s`` = 1500 (whisper's
    ``enc_seq``), where the ``Q_CHUNK`` query blocks do not apply; dense
    weights (see the module docstring)."""
    cfg, dense = reference_dense(ENCDEC)
    ref_p = _layer(dense["enc_blocks"]["attn"])
    port_p = _layer(bridge.params_from_reference(dense, device="cpu")["enc_blocks"]["attn"])
    x = _rand(np.random.default_rng(1), 1, 1500, cfg.d_model)
    pos = np.arange(1500)
    want, _ = jlayers.attention(cfg, ref_p, jnp.asarray(x), pos=jnp.asarray(pos), is_global=True,
                                causal=False, train=False)
    got, _ = layers.attention(cfg, port_p, torch.from_numpy(x), pos=torch.from_numpy(pos),
                              is_global=True, causal=False)
    _close(got, want, "out")


def test_zero_rows_quantize_as_the_reference():
    """The engine's stub frames and patches are zeros: an all-zero row's
    int8 codes and scale are the reference's bit for bit (the scale is the
    eps, never a NaN)."""
    a = np.zeros((4, 384), np.float32)
    a[1] = _rand(np.random.default_rng(2), 384)
    jq, js = jternary.quantize_activations(jnp.asarray(a))
    q, s = ternary.quantize_activations(torch.from_numpy(a))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert bool(torch.isfinite(s).all())


# ---------------------------------------------------------------------------
# models/encdec.py
# ---------------------------------------------------------------------------

def test_encode():
    """The encoder stack over random frames, on dense weights (see the
    module docstring)."""
    cfg, dense = reference_dense(ENCDEC)
    frames = _rand(np.random.default_rng(3), 2, cfg.enc_seq, cfg.d_model)
    want = jencdec.encode(cfg, dense, jnp.asarray(frames), train=False)
    got = encdec.encode(cfg, bridge.params_from_reference(dense, device="cpu"),
                        torch.from_numpy(frames))
    _close(got, want, "encoder states")


def test_cross_from_cache():
    """Decode-time cross-attention against cached encoder K/V."""
    cfg, frozen = reference_frozen(ENCDEC)
    ref_p = _layer(frozen["dec_blocks"]["xattn"])
    port_p = _layer(port_params(ENCDEC)["dec_blocks"]["xattn"])
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, cfg.d_model)
    xk, xv = (_rand(rng, 2, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim) for _ in range(2))
    want = jencdec._cross_from_cache(cfg, ref_p, jnp.asarray(x), jnp.asarray(xk),
                                     jnp.asarray(xv), False)
    got = encdec._cross_from_cache(cfg, port_p, torch.from_numpy(x), torch.from_numpy(xk),
                                   torch.from_numpy(xv))
    _close(got, want, "cross-attention out")


def test_encdec_forward():
    """Teacher-forced logits on dense weights against the reference (see
    the module docstring); on the frozen planes, the last position's equal
    the port's own ``prefill``."""
    cfg, dense = reference_dense(ENCDEC)
    batch = _encdec_batch(cfg, np.random.default_rng(5))
    rb, pb = _both(batch)
    want, aux = jzoo.forward(cfg, dense, rb, train=False)
    got, got_aux = model_zoo.forward(cfg, bridge.params_from_reference(dense, device="cpu"), pb)
    assert float(aux) == got_aux == 0.0
    assert tuple(got.shape) == (2, 12, cfg.padded_vocab)
    _close(got, want, "logits")
    _same_argmax(got, want)
    params = port_params(ENCDEC)
    full, _ = model_zoo.forward(cfg, params, pb)
    last, _ = model_zoo.prefill(cfg, params, pb, model_zoo.init_cache(cfg, 2, 12, device="cpu"))
    torch.testing.assert_close(full[:, -1:], last, rtol=1e-5, atol=1e-5)


def test_encdec_prefill_then_decode_steps():
    """``prefill`` of 12 tokens over random frames into a 24-row cache:
    last-row logits and all four cache leaves; then three ``decode_step``s
    at the shared length, the cross K/V unchanged."""
    cfg, frozen = reference_frozen(ENCDEC)
    params = port_params(ENCDEC)
    rng = np.random.default_rng(6)
    rb, pb = _both(_encdec_batch(cfg, rng))
    want, r_cache = jzoo.prefill(cfg, frozen, rb, jzoo.init_cache(cfg, 2, 24))
    got, p_cache = model_zoo.prefill(cfg, params, pb, model_zoo.init_cache(cfg, 2, 24,
                                                                           device="cpu"))
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab)
    assert set(p_cache) == {"k", "v", "xk", "xv"}
    _close(got, want, "prefill logits")
    _same_argmax(got, want)
    for n in ("k", "v", "xk", "xv"):
        _close(p_cache[n], r_cache[n], f"prefill {n}")
    xk = p_cache["xk"].clone()
    for t in range(12, 15):
        step = _tokens(rng, 2, 1)
        want, r_cache = jzoo.decode_step(cfg, frozen, jnp.asarray(step), r_cache, t)
        got, p_cache = model_zoo.decode_step(cfg, params, torch.from_numpy(step).long(),
                                             p_cache, t)
        _close(got, want, f"decode logits at t={t}")
        _same_argmax(got, want)
    for n in ("k", "v", "xk", "xv"):
        _close(p_cache[n], r_cache[n], f"decode {n}")
    assert torch.equal(p_cache["xk"], xk)


def test_encdec_chunk_step():
    """One rectangular step over random caches: a 4-token chunk at offset
    6, a decode token at offset 15 and a padding row; the head on every
    row, the cross K/V passed through."""
    cfg, frozen = reference_frozen(ENCDEC)
    rng = np.random.default_rng(7)
    shapes = encdec.cache_shapes(cfg, 3, 24)
    cache = {n: _rand(rng, *shape) for n, shape in shapes.items()}
    lengths = np.array([6, 15, 2])
    pos = lengths[:, None] + np.minimum(np.arange(4), np.array([[3], [0], [0]]))
    toks = _tokens(rng, 3, 4)
    want, r_cache = jzoo.chunk_step(cfg, frozen, jnp.asarray(toks), jnp.asarray(pos),
                                    {n: jnp.asarray(c) for n, c in cache.items()},
                                    jnp.asarray(lengths), train=False)
    got, p_cache = model_zoo.chunk_step(cfg, port_params(ENCDEC),
                                        torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                        {n: torch.from_numpy(c) for n, c in cache.items()},
                                        torch.from_numpy(lengths))
    assert tuple(got.shape) == (3, 4, cfg.padded_vocab)
    _close(got, want, "logits")
    _same_argmax(got, want)
    for n in ("k", "v", "xk", "xv"):
        _close(p_cache[n], r_cache[n], n)


# ---------------------------------------------------------------------------
# The VLM branch of models/transformer.py
# ---------------------------------------------------------------------------

def test_vlm_prefill_and_forward_with_patches():
    """Random patches go before 10 tokens: ``prefill`` fills cache rows
    [0, frontend_seq + 10) and gives the last row's logits; ``forward``
    gives every position's.  ``frontend_proj`` is a dense matmul."""
    cfg, frozen = reference_frozen(VLM)
    params = port_params(VLM)
    assert set(params["frontend_proj"]) == {"wd"}
    rng = np.random.default_rng(8)
    batch = {"tokens": _tokens(rng, 2, 10),
             "patches": _rand(rng, 2, cfg.frontend_seq, cfg.frontend_dim)}
    rb, pb = _both(batch)
    total = cfg.frontend_seq + 10
    want, r_cache = jzoo.prefill(cfg, frozen, rb, jzoo.init_cache(cfg, 2, total + 4))
    got, p_cache = model_zoo.prefill(cfg, params, pb,
                                     model_zoo.init_cache(cfg, 2, total + 4, device="cpu"))
    _close(got, want, "prefill logits")
    _same_argmax(got, want)
    for n in ("k", "v"):
        _close(p_cache[n], r_cache[n], n)
    assert float(p_cache["k"][:, :, :total].abs().amax()) > 0
    assert float(p_cache["k"][:, :, total:].abs().amax()) == 0
    want, _ = jzoo.forward(cfg, frozen, rb, train=False)
    full, _ = model_zoo.forward(cfg, params, pb)
    assert tuple(full.shape) == (2, total, cfg.padded_vocab)
    _close(full, want, "forward logits")
    torch.testing.assert_close(full[:, -1:], got, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Params trees and the paged cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_bridge_carries_family_trees(arch):
    """Every leaf of the reference's frozen tree comes across with its
    shape, dtype and bytes: ``enc_blocks``/``dec_blocks`` (with the cross
    block's planes), ``frontend_proj``."""
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
    if arch == ENCDEC:
        for leaf in ("['enc_blocks']['attn']['wq']['sign']",
                     "['dec_blocks']['xattn']['wk']['sign']", "['ln_enc']['g']"):
            assert leaf in want, leaf
    else:
        assert "['frontend_proj']['wd']" in want


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_init_params_layout_matches_reference(arch):
    """The port's ``init_params`` builds the reference's tree: the same leaf
    names, shapes and dtypes (its random numbers differ)."""
    cfg = jconfigs.get(arch).reduced()
    want = jax.eval_shape(lambda k: jzoo.init_params(cfg, k), jax.random.PRNGKey(0))
    got = model_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_w = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_g) == set(flat_w)
    for name, v in flat_w.items():
        assert tuple(flat_g[name].shape) == v.shape, name
        assert flat_g[name].dtype == torch.float32 and v.dtype == np.float32, name


def test_cross_kv_stays_dense_in_the_paged_cache():
    """``xk``/``xv`` keep a dense (L, slots, enc_seq, Hkv, Dh) layout beside
    the pooled K/V: the view passes them through and the scatter writes the
    view's tensors back."""
    cfg = jconfigs.get(ENCDEC).reduced()
    want = jax.eval_shape(lambda: jzoo.init_paged_cache(cfg, 3, 7, 4))
    pools = model_zoo.init_paged_cache(cfg, 3, 7, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in pools.items()} == {k: v.shape for k, v in want.items()}
    assert tuple(pools["xk"].shape) == (cfg.n_layers, 3, cfg.enc_seq, cfg.n_kv_heads,
                                        cfg.head_dim)
    table = np.array([[1, 2], [3, 0], [4, 5]])
    view = model_zoo.gather_cache_view(pools, torch.as_tensor(table))
    assert view["xk"] is pools["xk"] and view["xv"] is pools["xv"]
    new_xv = torch.ones_like(view["xv"])
    view["xv"] = new_xv
    out = model_zoo.scatter_cache_view(pools, model_zoo.first_writers(table, "cpu"), view)
    assert out["xv"] is new_xv


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_engine_matches_reference(arch):
    """Both families under ``whole`` (the default the engine picks): equal
    plans, greedy tokens and counters.  A VLM slot's length counts its
    ``frontend_seq`` patch positions."""
    lens = [3, 8, 21, 40, 5]
    run = run_pair(arch, _KW, lambda cls: requests(cls, lens, 5, 7))
    assert_same_run(*run)
    port = run[1]
    assert port.policy == "whole" and port.stats["whole_prefills"] == len(lens)
    extra = port.cfg.frontend_seq if arch == VLM else 0
    assert port.stats["max_step_tokens"] == max(lens) + extra


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_flat_and_chunked_are_refused(arch):
    """As in the reference: the engine refuses ``flat``/``chunked`` for both
    families."""
    cfg = jconfigs.get(arch).reduced()
    params = port_params(arch)
    for policy in ("flat", "chunked"):
        with pytest.raises(ValueError, match="unsupported for family"):
            ServingEngine(cfg, params, policy=policy, device="cpu", **_KW)


def test_decoder_only_module_refuses_encdec():
    """``transformer`` builds no enc-dec model; ``model_zoo`` sends that
    family to ``encdec``."""
    cfg = jconfigs.get(ENCDEC).reduced()
    with pytest.raises(ValueError, match="model_zoo dispatches it"):
        transformer.init_block(cfg, torch.Generator(), "cpu")
    assert set(model_zoo.init_cache(cfg, 1, 8, device="cpu")) == {"k", "v", "xk", "xv"}


def test_vlm_warmup_leaves_room_for_the_patches():
    """``warmup(seq_len=40)`` at ``max_len`` 32 on the reduced llava (16
    patch positions): the prompt is cut to 32 - 16 - 3 = 13 tokens, so it
    is admitted, in both packages, and the run stats are reset after it."""
    cfg, latent = reference_latent(VLM)
    kw = dict(_KW, max_len=32)
    ref = JServingEngine(cfg, latent, packed=True, **kw)
    port = ServingEngine(cfg, port_params(VLM), device="cpu", **kw)
    for eng in (ref, port):
        eng.warmup(seq_len=40)
        assert not eng.busy and eng.stats["steps"] == 0 and eng.stats["rejections"] == 0
        assert eng.kv.blocks_in_use == 0


def test_assert_same_run_catches_a_flipped_plane_byte():
    """The near-tie rule still catches a real fault: one byte of layer 0's
    ``mlp/w_down`` sign plane flipped in the port's copy of ``bitnet-2b-4t``
    (8 nonzero weights change sign) fails the ``flat`` scenario."""
    def flip(params):
        p = params["blocks"]["mlp"]["w_down"]
        assert int(p["zero"][0, 0, 0]) == 0          # all 8 weights nonzero
        p["sign"][0, 0, 0] ^= 0xFF

    run = run_pair("bitnet-2b-4t", _KW, lambda cls: requests(cls, [3, 8, 21, 40, 5], 5, 7),
                   mutate=flip)
    with pytest.raises(AssertionError, match="not a near tie"):
        assert_same_run(*run)
