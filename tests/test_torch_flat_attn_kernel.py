"""The flat step's float64 attention kernel (``kernels/flat_attn.py``,
``csrc/flat_attn.cu``) and its routing (``models.layers.flat_context``).

On the CPU: a CPU tensor takes the plain version, ``layers._flat_context``,
exactly; a meta tensor gets the kernel's output shape and one tally entry
that counts at most the view read once, the queries and the output, at the
heads of every dense and MoE config the flat policy serves; the kernel's
wrapper refuses other devices and inputs it does not take.

On the card (marked ``gpu``, skipped without CUDA): the kernel against the
plain version on the same CUDA tensors, within one float32 ulp, at the
reduced configs' windows and softcap, at full-width GQA groups of 1, 2, 4,
7 and 8, at head dims 128 and 256, on a bfloat16 view, with a bfloat16
context (within one bfloat16 ulp), and at the benchmark
cell's shapes (48 slots over 2,048 positions, a 48-row decode step and a
304-row step carrying a 256-row prompt chunk); padding rows are zeros; the
launch counter rises by one a call; two runs give the same bits; a token's
row has the same bits whatever other rows share its step; flat rows are
within one ulp of the chunked branch's core.  This file imports no JAX, so
it runs where the card is:
``python -m pytest --noconftest -q -p no:cacheprovider -m gpu
tests/test_torch_flat_attn_kernel.py`` with ``src`` on ``PYTHONPATH``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.kernels import flat_attn, tally
from repro_torch.models import layers


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the test (tiny ops, several test
    workers); restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _problem(cfg, rows, nb: int, vtok: int, seed: int, padding: int = 0,
             kv_dtype=torch.float32):
    """Flat-step inputs for ``cfg``'s heads: ``rows`` lists (slot, first
    position, count) runs in plan order, then ``padding`` rows of the slot
    sentinel ``nb``; queries and the view are standard normal (numpy seed)."""
    rng = np.random.default_rng(seed)
    slot = np.concatenate([np.full(n, s) for s, _, n in rows] + [np.full(padding, nb)])
    pos = np.concatenate([p + np.arange(n) for _, p, n in rows]
                         + [np.zeros(padding, np.int64)])
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rng.standard_normal((1, len(slot), h, dh), dtype=np.float32)
    view = [torch.from_numpy(rng.standard_normal((nb, vtok, hk, dh), dtype=np.float32))
            .to(kv_dtype) for _ in range(2)]
    return (torch.from_numpy(q), *view, torch.from_numpy(slot.astype(np.int64)),
            torch.from_numpy(pos.astype(np.int64)))


def _to(dev, *tensors):
    return tuple(t.to(dev) for t in tensors)


# The flat branch test's layout (tests/test_torch_flat_attention.py): three
# slots over a (3, 64) view, slot 0 appending 6 tokens at 40-45 (past the
# reduced window of 32), slot 1 decoding at 20, slot 2 prefilling 9 fresh
# tokens, then 3 padding rows.
SMALL = dict(rows=[(0, 40, 6), (1, 20, 1), (2, 0, 9)], nb=3, vtok=64, padding=3)
REDUCED = [("bitnet-2b-4t", True), ("gemma2-2b", False), ("gemma2-2b", True),
           ("gemma3-4b", False), ("gemma3-4b", True)]


@pytest.mark.parametrize("arch,flag", REDUCED)
def test_cpu_route_is_the_plain_version(arch, flag):
    """On CPU tensors ``flat_context`` is ``_flat_context``, bit for bit,
    and launches nothing."""
    cfg = configs.get(arch).reduced()
    q, ck, cv, slot, pos = _problem(cfg, seed=1, **SMALL)
    before = flat_attn.LAUNCHES["flat_attn"]
    got = layers.flat_context(cfg, q, ck, cv, slot, pos, flag, torch.float32)
    want = layers._flat_context(cfg, q, ck, cv, slot, pos, flag, torch.float32)
    assert torch.equal(got, want)
    assert flat_attn.LAUNCHES["flat_attn"] == before


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_route_records_one_kernel_call(kv_dtype, dtype):
    """On meta tensors at the benchmark cell's width (bitnet-2b-4t, 48
    slots over 2,048 positions, a 304-row step): the output's shape and
    dtype, one ``flat_attn`` tally entry whose bytes are at most the view
    read once plus the queries and the output, and no launch counted."""
    cfg = configs.get("bitnet-2b-4t")
    t, nb, vtok, dev = 304, 48, 2048, torch.device("meta")
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.empty((1, t, h, dh), dtype=dtype, device=dev)
    ck, cv = (torch.empty((nb, vtok, hk, dh), dtype=kv_dtype, device=dev) for _ in range(2))
    slot, pos = (torch.empty(t, dtype=torch.long, device=dev) for _ in range(2))
    before = flat_attn.LAUNCHES["flat_attn"]
    del tally.TALLY[:]
    try:
        ctx = layers.flat_context(cfg, q, ck, cv, slot, pos, True, dtype)
        calls = list(tally.TALLY)
    finally:
        del tally.TALLY[:]
    assert ctx.shape == (1, t, hk, h // hk, dh) and ctx.dtype == dtype
    assert [c.kernel for c in calls] == ["flat_attn"]
    view = 2 * nb * vtok * hk * dh * ck.element_size()
    # float32 queries; the kernel's output is float32, or float64 for the
    # wrapper to round once to another dtype.
    out = t * h * dh * (4 if dtype == torch.float32 else 8)
    assert calls[0].nbytes <= view + t * h * dh * 4 + out
    assert calls[0].ops == 4 * t * h * dh * vtok
    assert flat_attn.LAUNCHES["flat_attn"] == before


# The configs the flat policy serves through this branch: head dims 128 and
# 256, GQA groups of 1, 2, 4, 5, 7 and 8, sliding windows, a softcap.
FLAT_SERVED = ["bitnet-2b-4t", "deepseek-coder-33b", "deepseek-moe-16b", "gemma2-2b",
               "gemma3-4b", "llama4-maverick-400b-a17b", "qwen3-32b"]


@pytest.mark.parametrize("arch", FLAT_SERVED)
def test_meta_route_takes_every_served_config(arch):
    """Every dense and MoE config served under ``flat`` has a kernel
    instance: its full-width heads on a local layer (the window applies
    where the config has one) over a (4, 512) view go to one ``flat_attn``
    tally entry with the output's shape, and nothing raises."""
    cfg = configs.get(arch)
    t, nb, vtok, dev = 12, 4, 512, torch.device("meta")
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.empty((1, t, h, dh), device=dev)
    ck, cv = (torch.empty((nb, vtok, hk, dh), device=dev) for _ in range(2))
    slot, pos = (torch.empty(t, dtype=torch.long, device=dev) for _ in range(2))
    del tally.TALLY[:]
    try:
        ctx = layers.flat_context(cfg, q, ck, cv, slot, pos, False, torch.float32)
        calls = list(tally.TALLY)
    finally:
        del tally.TALLY[:]
    assert ctx.shape == (1, t, hk, h // hk, dh)
    assert [c.kernel for c in calls] == ["flat_attn"]


def test_kernel_wrapper_refuses_other_devices():
    """The wrapper itself has no CPU mode: CPU tensors raise (the route
    sends them to the plain version first)."""
    cfg = configs.get("bitnet-2b-4t").reduced()
    q, ck, cv, slot, pos = _problem(cfg, seed=2, **SMALL)
    with pytest.raises(ValueError, match="CUDA"):
        flat_attn.flat_attn_f64(q, ck, cv, slot, pos, window=0, softcap=0.0,
                                dtype=torch.float32)


def _meta_inputs(h=20, hk=5, dh=128, t=6, nb=3, vtok=64):
    dev = torch.device("meta")
    return dict(q=torch.empty((1, t, h, dh), device=dev),
                ck=torch.empty((nb, vtok, hk, dh), device=dev),
                cv=torch.empty((nb, vtok, hk, dh), device=dev),
                slot=torch.empty(t, dtype=torch.long, device=dev),
                pos=torch.empty(t, dtype=torch.long, device=dev))


@pytest.mark.parametrize("bad,error", [
    (dict(q=torch.empty((1, 6, 20, 128), dtype=torch.float64, device="meta")), TypeError),
    (dict(slot=torch.empty(6, dtype=torch.int32, device="meta")), TypeError),
    (dict(ck=torch.empty((3, 64, 5, 128), dtype=torch.float16, device="meta")), TypeError),
    (dict(cv=torch.empty((3, 64, 128, 5), device="meta").transpose(2, 3)), ValueError),
    (dict(pos=torch.empty(7, dtype=torch.long, device="meta")), ValueError),
    (dict(window=-1), ValueError),
])
def test_kernel_wrapper_checks_its_inputs(bad, error):
    """Wrong dtypes, a non-contiguous view, mismatched lengths and a
    negative window raise before anything is launched or tallied."""
    args = {**_meta_inputs(), **bad}
    window = args.pop("window", 0)
    with pytest.raises(error):
        flat_attn.flat_attn_f64(**args, window=window, softcap=0.0, dtype=torch.float32)


@pytest.mark.parametrize("shape", [dict(dh=48, h=8, hk=4), dict(dh=64, h=8, hk=4),
                                   dict(dh=128, h=66, hk=2),
                                   dict(dh=128, h=20, hk=3)])
def test_kernel_wrapper_refuses_shapes_without_an_instance(shape):
    """A head dim outside 32/128/256, a GQA group above 32 and query
    heads that do not divide over the KV heads raise."""
    with pytest.raises(ValueError):
        flat_attn.flat_attn_f64(**_meta_inputs(**shape), window=0, softcap=0.0,
                                dtype=torch.float32)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _within_one_ulp(got: torch.Tensor, want: torch.Tensor, what: str):
    """Every value within one ulp of the tensors' dtype (float32, or
    bfloat16: its 8-bit significand is float32's less 16 bits)."""
    a, b = got.float().cpu().numpy(), want.float().cpu().numpy()
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    if got.dtype == torch.bfloat16:
        ulp = ulp * 2.0 ** 16
    bad = np.abs(a - b) > ulp
    assert not bad.any(), f"{what}: {int(bad.sum())} values past one ulp, {np.abs(a - b).max()}"


def _kernel_and_plain(cfg, flag, inputs, dtype=torch.float32):
    q, ck, cv, slot, pos = inputs
    before = flat_attn.LAUNCHES["flat_attn"]
    got = layers.flat_context(cfg, q, ck, cv, slot, pos, flag, dtype)
    want = layers._flat_context(cfg, q, ck, cv, slot, pos, flag, dtype)
    torch.cuda.synchronize()
    assert flat_attn.LAUNCHES["flat_attn"] == before + 1
    return got, want


def _cell_rows(rng, t: int):
    """The benchmark cell's step layouts over 48 slots of 2,048 positions:
    T 48 is a decode row in every slot at mixed positions; T 304 is 47
    decode rows, a 256-row prompt chunk of slot 47 at positions 600-855 and
    one padding row."""
    decode = rng.integers(1, 2048, size=48)
    if t == 48:
        return [(s, int(p), 1) for s, p in enumerate(decode)], 0
    return [(s, int(p), 1) for s, p in enumerate(decode[:47])] + [(47, 600, 256)], 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch,flag", REDUCED)
def test_card_kernel_matches_plain_reduced(cuda, arch, flag):
    """The flat branch test's cases (reduced configs: window 32 and, on
    gemma2-2b, the softcap of 50 on local layers; global layers): real rows
    within one float32 ulp of the plain version, padding rows zero."""
    cfg = configs.get(arch).reduced()
    inputs = _to(cuda, *_problem(cfg, seed=3, **SMALL))
    got, want = _kernel_and_plain(cfg, flag, inputs)
    real = inputs[3] < SMALL["nb"]
    _within_one_ulp(got[0, real], want[0, real], f"{arch} global={flag}")
    assert not got[0, ~real].any()


@pytest.mark.gpu
@pytest.mark.parametrize("arch,flag,nb,vtok,rows", [
    ("deepseek-coder-33b", True, 3, 512, [(0, 300, 9), (1, 40, 1), (2, 0, 17)]),    # G = 7
    ("deepseek-moe-16b", True, 3, 512, [(0, 300, 9), (1, 40, 1), (2, 0, 40)]),      # G = 1
    ("qwen3-32b", True, 3, 512, [(0, 300, 9), (1, 40, 1), (2, 0, 5)]),              # G = 8
    ("gemma3-4b", False, 2, 2048, [(0, 1500, 20), (1, 1900, 1)]),    # G = 2, Dh 256, window
    ("gemma2-2b", False, 2, 1024, [(0, 600, 20), (1, 900, 1)]),      # Dh 256, softcap 50
])
def test_card_kernel_matches_plain_full_width(cuda, arch, flag, nb, vtok, rows):
    """Full-width heads: GQA groups of 7, 1 and 8 at Dh 128; Dh 256 with
    gemma3-4b's 1,024-token window biting and gemma2-2b's softcap."""
    cfg = configs.get(arch)
    inputs = _to(cuda, *_problem(cfg, rows, nb, vtok, seed=4, padding=2))
    got, want = _kernel_and_plain(cfg, flag, inputs)
    real = inputs[3] < nb
    _within_one_ulp(got[0, real], want[0, real], arch)
    assert not got[0, ~real].any()


@pytest.mark.gpu
@pytest.mark.parametrize("t", [48, 304])
def test_card_kernel_matches_plain_at_the_cell_shapes(cuda, t):
    """bitnet-2b-4t's heads over the cell's (48, 2,048) view: a decode step
    of 48 rows and a 304-row step carrying a 256-row chunk."""
    cfg = configs.get("bitnet-2b-4t")
    rows, padding = _cell_rows(np.random.default_rng(5), t)
    inputs = _to(cuda, *_problem(cfg, rows, 48, 2048, seed=5, padding=padding))
    got, want = _kernel_and_plain(cfg, True, inputs)
    real = inputs[3] < 48
    _within_one_ulp(got[0, real], want[0, real], f"T {t}")
    assert not got[0, ~real].any()


@pytest.mark.gpu
def test_card_kernel_on_a_bfloat16_view(cuda):
    """A bfloat16 cache view (the benchmark's control): within one ulp of
    the plain version on the same view."""
    cfg = configs.get("bitnet-2b-4t")
    rows = [(0, 300, 9), (1, 40, 1), (2, 0, 17)]
    inputs = _to(cuda, *_problem(cfg, rows, 3, 512, seed=6, padding=1,
                                 kv_dtype=torch.bfloat16))
    got, want = _kernel_and_plain(cfg, True, inputs)
    real = inputs[3] < 3
    _within_one_ulp(got[0, real], want[0, real], "bf16 view")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,flag", [("bitnet-2b-4t", True), ("gemma2-2b", False)])
def test_card_kernel_rounds_once_to_bfloat16(cuda, arch, flag):
    """A bfloat16 context: the kernel's float64 result rounded once to
    bfloat16, as the plain version rounds its float64 context, so within
    one bfloat16 ulp of it (full-width heads; gemma2-2b's softcap and
    window); padding rows zero."""
    cfg = configs.get(arch)
    rows = [(0, 300, 9), (1, 40, 1), (2, 0, 17)]
    inputs = _to(cuda, *_problem(cfg, rows, 3, 512, seed=10, padding=2))
    got, want = _kernel_and_plain(cfg, flag, inputs, dtype=torch.bfloat16)
    assert got.dtype == want.dtype == torch.bfloat16
    real = inputs[3] < 3
    _within_one_ulp(got[0, real], want[0, real], f"{arch} bf16 context")
    assert not got[0, ~real].any()


@pytest.mark.gpu
def test_card_kernel_repeats_its_bits_and_ignores_its_neighbours(cuda):
    """Two calls on the same inputs give the same bits; the 47 decode rows
    of the 304-row cell step have the same bits as the same rows computed
    alone in a 47-row step."""
    cfg = configs.get("bitnet-2b-4t")
    rows, padding = _cell_rows(np.random.default_rng(7), 304)
    q, ck, cv, slot, pos = _to(cuda, *_problem(cfg, rows, 48, 2048, seed=7, padding=padding))
    one = layers.flat_context(cfg, q, ck, cv, slot, pos, True, torch.float32)
    two = layers.flat_context(cfg, q, ck, cv, slot, pos, True, torch.float32)
    alone = layers.flat_context(cfg, q[:, :47].contiguous(), ck, cv, slot[:47].contiguous(),
                                pos[:47].contiguous(), True, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(one, two)
    assert torch.equal(one[:, :47], alone)


@pytest.mark.gpu
def test_card_flat_rows_equal_the_chunked_core(cuda):
    """The same tokens at bitnet-2b-4t's heads through the chunked branch's
    core (each slot's rows from its own offset, padded to 9 rows, causal in
    absolute position, ``layers.context`` in float64) on the same view: every
    real token's context within one float32 ulp of the kernel's."""
    cfg = configs.get("bitnet-2b-4t")
    rows = [(0, 40, 6), (1, 20, 1), (2, 0, 9)]
    nb, vtok, width = 3, 512, 9
    q, ck, cv, slot, pos = _to(cuda, *_problem(cfg, rows, nb, vtok, seed=8, padding=3))
    flat = layers.flat_context(cfg, q, ck, cv, slot, pos, True, torch.float32)
    h, dh = cfg.n_heads, cfg.head_dim
    qc = torch.zeros((nb, width, h, dh), device=cuda)
    qabs = torch.zeros((nb, width), dtype=torch.long, device=cuda)
    for s, p0, n in rows:
        qc[s, :n] = q[0, slot == s]
        qabs[s] = p0 + torch.arange(width, device=cuda)
    kpos = torch.arange(vtok, device=cuda)[None, None, :]
    mask = (kpos <= qabs[:, :, None])[:, None, None, :, :]
    chunked = layers.context(cfg, qc, ck, cv, mask, torch.float32)
    for s, _, n in rows:
        _within_one_ulp(flat[0, slot == s], chunked[s, :n], f"slot {s}")


@pytest.mark.gpu
def test_card_kernel_matches_plain_with_a_window_inside_a_chunk(cuda):
    """A window that cuts a 256-row chunk's keys in mid-block (bitnet-2b-4t's
    heads with a 100-token window on a local layer): within one ulp of the
    plain version."""
    cfg = dataclasses.replace(configs.get("bitnet-2b-4t"), window_pattern=("L",),
                              window_size=100)
    rows = [(0, 333, 256), (1, 1000, 1), (2, 7, 1)]
    inputs = _to(cuda, *_problem(cfg, rows, 3, 2048, seed=9, padding=1))
    got, want = _kernel_and_plain(cfg, False, inputs)
    real = inputs[3] < 3
    _within_one_ulp(got[0, real], want[0, real], "window 100")
