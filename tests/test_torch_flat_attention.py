"""The flat branch of ``models.layers.attention`` (the ``flat`` serving
policy): its footprint at full width on the meta device, and its agreement
on the CPU with the reference's flat branch and with the port's own chunked
branch.

A flat step packs T tokens of many slots into one (1, T) batch over a
(B, Vtok) cache view.  The branch must never make a tensor of
T x Vtok x Hk x Dh elements (a copy of each token's slot key row): at
bitnet-2b-4t's 4096-token context one 516-token step would then ask for
36.79 GiB and read 4.3 TB.  The footprint bounds are the reference layout's
counts (one B x Vtok key axis under a segment mask, float64 core: 3.89 GiB
and 539.5 GB for bitnet-2b-4t, 6.81 GiB and 595.3 GB for gemma2-2b) plus
about 15 %.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import one_torch_thread, port_params, reference_frozen  # noqa: F401
from torch.utils import _pytree as pytree

import repro_torch.configs as configs
from repro.models import layers as jlayers
from repro_torch.kernels import tally
from repro_torch.launch import dryrun
from repro_torch.models import layers, model_zoo
from repro_torch.serving.engine import freeze_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-4, atol=1e-4)


class _Largest(dryrun.MetaTrace):
    """:class:`dryrun.MetaTrace` that also keeps the element count of the
    largest op output."""

    def __init__(self, exclude: set):
        super().__init__(exclude)
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("arch,t,vtok,peak_gib,accessed_gb", [
    ("bitnet-2b-4t", 516, 4096, 4.5, 620),
    ("gemma2-2b", 516, 8192, 8.0, 690),
])
def test_flat_step_footprint_at_full_width(arch, t, vtok, peak_gib, accessed_gb):
    """One full-width ``model_zoo.flat_step`` on meta (packed weights, a
    bf16 cache view of 4 slots, a 512-token chunk plus 4 rows): the live
    bytes beyond the step's arguments and the bytes its ops access stay
    within the reference layout's, and no op output holds T x Vtok x Hk x
    Dh elements."""
    cfg = configs.get(arch)
    params = freeze_params(model_zoo.param_specs(cfg))
    b = 4
    shape = (cfg.n_layers, b, vtok, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: torch.empty(shape, dtype=torch.bfloat16, device="meta") for n in ("k", "v")}
    tokens = torch.empty(t, dtype=torch.int32, device="meta")
    slot, pos = (torch.empty(t, dtype=torch.long, device="meta") for _ in range(2))
    emit_row = torch.empty(b, dtype=torch.long, device="meta")
    args = (params, tokens, slot, pos, cache, emit_row)
    trace = _Largest(dryrun._storage_keys(args))
    try:
        with trace:
            logits, new_cache = model_zoo.flat_step(cfg, *args)
    finally:
        del tally.TALLY[:]
    assert logits.shape[0] == b
    assert new_cache["k"].shape == shape
    assert trace.largest < t * vtok * cfg.n_kv_heads * cfg.head_dim
    assert trace.peak <= peak_gib * 2**30, trace.peak / 2**30
    assert trace.bytes_accessed <= accessed_gb * 1e9, trace.bytes_accessed / 1e9


# Three slots over a (3, 64) view: slot 0 has a 40-token prefix in the cache
# and appends 6 tokens (positions 40-45, past the reduced window of 32),
# slot 1 decodes one token at 20, slot 2 prefills 9 fresh tokens; then 3
# padding rows (slot sentinel 3).
SLOTS, VTOK = 3, 64
STARTS, COUNTS = (40, 20, 0), (6, 1, 9)
PADDING = 3


def _flat_case(seed: int):
    rng = np.random.default_rng(seed)
    slot = np.concatenate([np.full(n, i) for i, n in enumerate(COUNTS)]
                          + [np.full(PADDING, SLOTS)])
    pos = np.concatenate([s + np.arange(n) for s, n in zip(STARTS, COUNTS)]
                         + [np.zeros(PADDING, np.int64)])
    x = rng.standard_normal((1, len(slot), 128), dtype=np.float32)
    cache = {n: rng.standard_normal((SLOTS, VTOK, 2, 32), dtype=np.float32)
             for n in ("k", "v")}
    return x, slot, pos, cache


def _layer0(arch):
    cfg, frozen = reference_frozen(arch)
    ref = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in frozen["blocks"]["attn"].items()}
    port = {k: {kk: vv[0] for kk, vv in v.items()}
            for k, v in port_params(arch)["blocks"]["attn"].items()}
    return cfg, ref, port


def _flat_port(cfg, p, x, slot, pos, cache, flag):
    return layers.attention(cfg, p, torch.from_numpy(x), pos=torch.from_numpy(pos),
                            is_global=flag, slot=torch.from_numpy(slot),
                            cache={n: torch.from_numpy(c) for n, c in cache.items()})


def _within_one_ulp(got: torch.Tensor, want: torch.Tensor, what: str):
    a, b = got.numpy(), want.numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a - b) <= ulp), f"{what}: {np.abs(a - b).max()} apart"


CASES = [("bitnet-2b-4t", True), ("gemma2-2b", False), ("gemma2-2b", True),
         ("gemma3-4b", False), ("gemma3-4b", True)]


@pytest.mark.parametrize("passes", ["one", "per slot"])
@pytest.mark.parametrize("arch,flag", CASES)
def test_flat_branch_matches_reference(arch, flag, passes, monkeypatch):
    """Ragged rows of three slots, a prefix already cached and padding rows
    through both packages' flat branch (local layers: window 32 and, on
    gemma2-2b, the softcap; global layers): the real tokens' outputs and
    the updated view agree within 1e-4, padding rows stay finite.  ``per
    slot`` shrinks ``FLAT_SCORES`` so that every slot is a pass of its
    own."""
    if passes == "per slot":
        monkeypatch.setattr(layers, "FLAT_SCORES", 1)
    cfg, ref_p, port_p = _layer0(arch)
    x, slot, pos, cache = _flat_case(11)
    r_out, r_cache = jlayers.attention(cfg, ref_p, jnp.asarray(x), pos=jnp.asarray(pos),
                                       is_global=flag, slot=jnp.asarray(slot), train=False,
                                       cache={n: jnp.asarray(c) for n, c in cache.items()})
    p_out, p_cache = _flat_port(cfg, port_p, x, slot, pos, cache, flag)
    real = slot < SLOTS
    np.testing.assert_allclose(p_out[0, real].numpy(), np.asarray(r_out)[0, real],
                               err_msg="out", **TOL)
    assert bool(torch.isfinite(p_out).all())
    for n in ("k", "v"):
        np.testing.assert_allclose(p_cache[n].numpy(), np.asarray(r_cache[n]), err_msg=n, **TOL)


@pytest.mark.parametrize("passes", ["one", "per slot"])
@pytest.mark.parametrize("arch,flag", CASES)
def test_flat_rows_equal_the_chunked_branch(arch, flag, passes, monkeypatch):
    """The same tokens through the chunked branch (each slot's rows from its
    own offset, 9 rows per slot, the rows past a slot's tokens padding) on
    the same cache: every real token's output is within one float32 ulp of
    the flat step's, and the cells both write hold the same bits.  The
    float64 core, rounded once, is what makes the two layouts round
    alike."""
    if passes == "per slot":
        monkeypatch.setattr(layers, "FLAT_SCORES", 1)
    cfg, _, port_p = _layer0(arch)
    x, slot, pos, cache = _flat_case(12)
    f_out, f_cache = _flat_port(cfg, port_p, x, slot, pos, cache, flag)
    width = max(COUNTS)
    xc = np.zeros((SLOTS, width, x.shape[-1]), np.float32)
    for i in range(SLOTS):
        xc[i, :COUNTS[i]] = x[0, slot == i]
    starts = np.array(STARTS)
    c_out, c_cache = layers.attention(
        cfg, port_p, torch.from_numpy(xc), pos=torch.from_numpy(starts[:, None] + np.arange(width)),
        is_global=flag, cache={n: torch.from_numpy(c) for n, c in cache.items()},
        cache_len=torch.from_numpy(starts))
    for i in range(SLOTS):
        mine = torch.from_numpy(slot == i)
        _within_one_ulp(f_out[0, mine], c_out[i, :COUNTS[i]], f"slot {i}")
        for n in ("k", "v"):
            cells = slice(STARTS[i], STARTS[i] + COUNTS[i])
            assert torch.equal(f_cache[n][i, cells], c_cache[n][i, cells])
