"""Port vs reference: the small public names of the reference the port
carries beside their counterparts (``core/ternary``, ``kernels/tsar_matmul``,
``sparse/format``'s padded pool, ``serving/kv_cache``,
``models/transformer``), on the same
numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import ternary as jternary
from repro.models import transformer as jtransformer
from repro.serving import kv_cache as jkv
from repro.sparse import format as jformat
import repro_torch.configs as configs
from repro_torch.core import ternary
from repro_torch.models import transformer
from repro_torch.serving import kv_cache
from repro_torch.sparse import format as sparse_format


def _ternary(k: int, m: int, seed: int = 0, p_zero: float = 1 / 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.choice(np.array([-1, 1], np.int8), size=(k, m))
    return np.where(rng.random((k, m)) < p_zero, 0, t).astype(np.float32)


@pytest.mark.parametrize("k,m", [(64, 24), (200, 7)])
def test_decompose_recompose_equal_reference(k, m):
    t = _ternary(k, m)
    w_d, w_s = ternary.decompose(torch.from_numpy(t))
    jw_d, jw_s = jternary.decompose(jnp.asarray(t))
    assert np.array_equal(w_d.numpy(), np.asarray(jw_d))
    assert np.array_equal(w_s.numpy(), np.asarray(jw_s))
    assert set(np.unique(w_d.numpy())) <= {-1.0, 1.0} and set(np.unique(w_s.numpy())) <= {0, 1}
    assert np.array_equal(ternary.recompose(w_d, w_s).numpy(), t)
    assert np.array_equal(np.asarray(jternary.recompose(jw_d, jw_s)), t)


def test_tsar_matmul_pack_equal_reference():
    """``kernels/tsar_matmul.PACK``, weights per plane byte."""
    from repro.kernels import tsar_matmul as jtsar_matmul

    from repro_torch.kernels import tsar_matmul

    assert tsar_matmul.PACK == jtsar_matmul.PACK == ternary.PACK == 8


def test_bytes_per_weight_equal_reference():
    assert ternary.packed_bytes_per_weight() == jternary.packed_bytes_per_weight() == 0.25
    assert ternary.tl2_bytes_per_weight() == jternary.tl2_bytes_per_weight()


@pytest.mark.parametrize("k,m", [(64, 24), (256, 40)])
def test_np_pack_reference_equal_reference(k, m):
    """The numpy oracle gives the reference's planes, and the port's
    ``pack`` gives the oracle's."""
    t = _ternary(k, m, seed=k)
    sign, zero = ternary.np_pack_reference(t)
    jsign, jzero = jternary.np_pack_reference(t)
    assert np.array_equal(sign, jsign) and np.array_equal(zero, jzero)
    tw = ternary.pack(torch.from_numpy(t))
    assert np.array_equal(tw.sign_plane.numpy(), sign)
    assert np.array_equal(tw.zero_plane.numpy(), zero)


@pytest.mark.parametrize("k,m", [(64, 24), (200, 7)])
def test_ternary_weights_shape_and_nbytes_equal_reference(k, m):
    t = _ternary(k, m, seed=1)
    scale = np.linspace(0.5, 1.5, m, dtype=np.float32)
    tw = ternary.pack(torch.from_numpy(t), torch.from_numpy(scale))
    jtw = jternary.pack(jnp.asarray(t), jnp.asarray(scale))
    assert (tw.k, tw.m, tw.nbytes()) == (jtw.k, jtw.m, jtw.nbytes()) == (
        k, m, 2 * (-(-k // 8)) * m + 4 * m)


@pytest.mark.parametrize("bk,bm,dead", [(64, 32, 0.5), (32, 16, 0.0), (64, 64, 1.0)])
def test_padded_pool_k_m_block_density_equal_reference(bk, bm, dead):
    """A (256, 128) matrix with a seeded share of its blocks zeroed."""
    k, m = 256, 128
    t = _ternary(k, m, seed=3)
    rng = np.random.default_rng(4)
    kill = rng.random((k // bk, m // bm)) < dead
    t = t * np.repeat(np.repeat(~kill, bk, 0), bm, 1).astype(np.float32)
    p = sparse_format.pad_from_ternary(torch.from_numpy(t), bk=bk, bm=bm)
    jp = jformat.pad_from_ternary(jnp.asarray(t), bk=bk, bm=bm)
    assert (p.k, p.m) == (jp.k, jp.m) == (k, m)
    assert float(p.block_density) == pytest.approx(float(jp.block_density), abs=0)
    assert float(p.block_density) == pytest.approx(1 - kill.mean())


def test_kv_cache_live_tokens_and_table_view_equal_reference():
    """The same allocator operations on both caches (grow, fork, free),
    each slot's length set as the engine sets it: live tokens and table
    views (within and past ``max_blocks``) equal."""
    cfg, jcfg = configs.get("bitnet-2b-4t").reduced(), jconfigs.get("bitnet-2b-4t").reduced()
    cache = kv_cache.PagedKVCache(cfg, 3, 40, block_size=8, device="cpu")
    jcache = jkv.PagedKVCache(jcfg, 3, 40, block_size=8)
    live = []
    for op in (("ensure", 0, 17), ("ensure", 1, 5), ("ensure", 2, 33), ("free", 1),
               ("ensure", 0, 30), ("fork", 1, 0), ("ensure", 1, 20)):
        for c in (cache, jcache):
            if op[0] == "ensure":
                assert c.ensure(op[1], op[2])
                c.lengths[op[1]] = op[2]
            elif op[0] == "free":
                c.free_slot(op[1])
            else:
                c.fork_blocks(op[1], [int(b) for b in c.table[op[2], :2]])
        assert cache.live_tokens() == jcache.live_tokens()
        for vb in (1, 4, 8):
            got = cache.table_view(vb)
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            assert np.array_equal(got.numpy(), np.asarray(jcache.table_view(vb)))
            assert np.array_equal(got.numpy(), cache.host_table(vb))
        live.append(cache.live_tokens())
    assert live == [17, 22, 55, 50, 63, 63, 83]


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-4b", "hymba-1.5b", "bitnet-2b-4t"])
def test_global_flags_equal_reference(arch):
    cfg = configs.get(arch)
    flags = transformer.global_flags(cfg, "cpu")
    assert flags.dtype == torch.bool and tuple(flags.shape) == (cfg.n_layers,)
    assert np.array_equal(flags.numpy(), np.asarray(jtransformer.global_flags(jconfigs.get(arch))))
