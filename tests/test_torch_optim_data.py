"""Port vs reference: ``optim/`` (AdamW, the schedule, clipping, the int8
error-feedback compression) and ``data/pipeline.py``, on the CPU.

Inputs are numpy-seeded.  ``adamw_update`` agrees within 1e-6 (relative
L2 per leaf) with float32 and with bfloat16 moments; the schedule, the
global norm and the clip within 1e-6; ``compress_leaf`` bit for bit,
the single-process ``psum_compressed`` against the reference's over a
one-device mesh (gradients bit for bit, error buffers within 2^-20: the
compiled reference fuses one multiply-add) and its exchange over a
one-rank process group; the synthetic stream value for value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMStream as JStream
from repro.optim import AdamWState as JAdamWState
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import compression as jcompression
from repro.optim import cosine_schedule as jcosine
from repro.optim.optimizer import clip_by_global_norm as jclip
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLMStream
from repro_torch.optim import (AdamWState, OptConfig, adamw_update, clip_by_global_norm,
                               compression, cosine_schedule, global_norm)


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((32, 48)) * scale).astype(np.float32)},
            "b": (rng.standard_normal((3, 40, 24)) * scale).astype(np.float32),
            "g": (rng.standard_normal((48,)) * scale).astype(np.float32)}


def _torch(tree, dtype=None):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(
        dtype or torch.float32), tree)


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x.float() if isinstance(x, torch.Tensor)
                                             else jnp.asarray(x, jnp.float32)), tree)


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Three updates from the same moments: params, both moments and the
    metrics; the clip is active (grads scaled above ``clip_norm``) and the
    first step is inside the warmup."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moment_dtype,
               clip_norm=1.0)
    jcfg, tcfg = JOptConfig(**cfg), OptConfig(**cfg)
    params = _tree(0)
    mdt = getattr(jnp, moment_dtype)
    jstate = JAdamWState(jax.tree.map(lambda x: jnp.zeros(x.shape, mdt), params),
                         jax.tree.map(lambda x: jnp.zeros(x.shape, mdt), params),
                         jnp.zeros((), jnp.int32))
    tp = _torch(params)
    tstate = AdamWState(jax.tree.map(lambda x: torch.zeros_like(x, dtype=getattr(
        torch, moment_dtype)), tp), jax.tree.map(lambda x: torch.zeros_like(
            x, dtype=getattr(torch, moment_dtype)), tp), torch.zeros((), dtype=torch.int32))
    jp = jax.tree.map(jnp.asarray, params)
    for step in range(3):
        grads = _tree(10 + step, scale=0.3)
        jp, jstate, jm = jadamw_update(jcfg, jax.tree.map(jnp.asarray, grads), jstate, jp)
        tp, tstate, tm = adamw_update(tcfg, _torch(grads), tstate, tp)
        for got, want in ((tp, jp), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            for g, w in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(_np(want))):
                assert _rel(g, w) <= 1e-6, step
        assert tstate.mu["b"].dtype == getattr(torch, moment_dtype)
        assert int(tstate.count) == step + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k])), k


def test_adamw_update_is_in_place():
    params = _torch(_tree(0))
    state = AdamWState(jax.tree.map(torch.zeros_like, params),
                       jax.tree.map(torch.zeros_like, params), torch.zeros((), dtype=torch.int32))
    before = params["b"].clone()
    out, new, _ = adamw_update(OptConfig(warmup_steps=1), _torch(_tree(1)), state, params)
    assert out["b"] is params["b"] and not torch.equal(before, params["b"])
    assert new.mu["b"] is state.mu["b"]


def test_schedule_norm_and_clip_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jcosine(JOptConfig(**cfg), jnp.asarray(s, jnp.int32)))
        got = float(cosine_schedule(OptConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(want, 1e-12), s
    tree = _tree(3, scale=2.0)
    jc, jn = jclip(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = clip_by_global_norm(_torch(tree), 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert abs(float(global_norm(_torch(tree))) - float(jn)) <= 1e-6 * float(jn)
    for g, w in zip(jax.tree.leaves(_np(tc)), jax.tree.leaves(_np(jc))):
        assert _rel(g, w) <= 1e-6


def test_compress_leaf_bit_exact():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((1000,)).astype(np.float32)
    err = (rng.standard_normal((1000,)) * 1e-3).astype(np.float32)
    wq, ws, we = jcompression.compress_leaf(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = compression.compress_leaf(torch.from_numpy(g), torch.from_numpy(err))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
    assert float(ts) == float(ws)
    np.testing.assert_array_equal(te.numpy(), np.asarray(we))


def test_psum_compressed_single_process_bit_exact():
    """A world of one process against the reference's shard_map over a
    one-device mesh: the int8 round trip for large leaves, tiny leaves
    unchanged, and the error buffers."""
    from jax.experimental.shard_map import shard_map

    rng = np.random.default_rng(1)
    grads = {"w": rng.standard_normal((64, 64)).astype(np.float32),
             "s": rng.standard_normal((7,)).astype(np.float32)}
    err = {"w": (rng.standard_normal((64, 64)) * 1e-3).astype(np.float32),
           "s": np.zeros((7,), np.float32)}
    mesh = jax.make_mesh((1,), ("data",))
    want_g, want_e = jax.jit(shard_map(
        lambda g, e: jcompression.psum_compressed(g, e, "data"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()), check_rep=False))(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err))
    got_g, got_e = compression.psum_compressed(_torch(grads), _torch(err))
    for k in grads:
        np.testing.assert_array_equal(got_g[k].numpy(), np.asarray(want_g[k]), err_msg=k)
        # Compiled, XLA contracts ``target - q * scale`` into one fused
        # multiply-add: the error buffers agree to its rounding (the eager
        # ``compress_leaf`` above is bit for bit).
        np.testing.assert_allclose(got_e[k].numpy(), np.asarray(want_e[k]), rtol=0,
                                   atol=2.0 ** -20, err_msg=k)
    np.testing.assert_array_equal(got_g["s"].numpy(), grads["s"])


def test_psum_compressed_refuses_a_process_group(tmp_path):
    """A process group is taken, no longer refused: the exchange itself
    (int8 all-to-all, scale all-gather, bf16 all-gather) over a one-rank
    gloo group gives the single-process mean bit for bit, a ragged leaf
    included.  Several ranks against the reference: ``test_torch_distributed``."""
    import torch.distributed as dist

    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal((3001,)).astype(np.float32))
    e = torch.from_numpy((rng.standard_normal((3001,)) * 1e-3).astype(np.float32))
    q, scale, _ = compression.compress_leaf(g, e)
    want, _ = compression.psum_compressed({"w": g.clone()}, {"w": e.clone()})
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        got = compression._allreduce_int8(q, scale, None, 1)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got.numpy(), want["w"].numpy())


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_stream_bit_identical_to_reference(n_hosts, host_id):
    kw = dict(vocab_size=512, seq_len=32, global_batch=8, n_hosts=n_hosts,
              host_id=host_id, seed=7)
    want, got = JStream(JDataConfig(**kw)), SyntheticLMStream(DataConfig(**kw))
    for step in (0, 5, 1000):
        wb, gb = want.batch(step), got.batch(step, device="cpu")
        for k in ("tokens", "labels"):
            assert gb[k].dtype == torch.int64
            np.testing.assert_array_equal(gb[k].numpy(), np.asarray(wb[k]))
            np.testing.assert_array_equal(got.batch_numpy(step)[k], np.asarray(wb[k]))


def test_prefetch_iterator_order_and_errors():
    stream = SyntheticLMStream(DataConfig(vocab_size=128, seq_len=8, global_batch=4, seed=3))
    it = PrefetchIterator(stream, start_step=10, device="cpu")
    try:
        for expect in (10, 11, 12):
            step, batch = next(it)
            assert step == expect
            assert torch.equal(batch["tokens"], stream.batch(expect, device="cpu")["tokens"])
    finally:
        it.close()
    assert not it._thread.is_alive()

    class Broken(SyntheticLMStream):
        def batch(self, step, device="cuda"):
            raise RuntimeError("no batch")

    it = PrefetchIterator(Broken(stream.cfg), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="no batch"):
            next(it)
    finally:
        it.close()
