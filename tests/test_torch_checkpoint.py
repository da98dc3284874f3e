"""Checkpoints, restarts and the fault-tolerance primitives of the port
(``checkpoint/``, ``runtime/``), on the CPU.

The reference's ``tests/test_fault_tolerance.py`` mirrored without JAX
(round trip and GC, async save, crash recovery bit for bit, restarts
under fault injection, stragglers, heartbeats, the elastic plan), and the
format across packages: a checkpoint written by either restores in the
other, float32 trees exactly.  bfloat16 leaves (moments with
``moment_dtype="bfloat16"``): both packages write the same raw 2-byte
words; the port restores the reference's bit for bit, and the reference
cannot restore a bfloat16 leaf at all, its own or the port's (numpy has no
cast from the raw ``V2`` words it reads back).
"""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import one_torch_thread, reference_latent  # noqa: F401

from repro import checkpoint as jckpt
from repro.optim import OptConfig as JOptConfig
from repro.train import init_state as jinit_state
from repro_torch import bridge
from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.optim import AdamWState, OptConfig, adamw_init
from repro_torch.runtime import (Heartbeat, StepMonitor, elastic_remesh_plan,
                                 run_with_restarts)
from repro_torch.train import TrainState, init_state, make_train_step

# Tiny reduced-config ops: one torch thread per test worker (see the fixture).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "bitnet-2b-4t"


@pytest.fixture(scope="module")
def setup():
    cfg, _ = reference_latent(ARCH)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 32, 4, seed=5))
    return cfg, opt, stream


def _state(cfg, opt, seed: int) -> TrainState:
    return init_state(cfg, torch.Generator().manual_seed(seed), opt, device="cpu")


def _leaves(tree) -> dict:
    from repro_torch.checkpoint.checkpointing import _flatten

    return _flatten(tree)


def _assert_equal_trees(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_checkpoint_roundtrip_and_gc(setup, tmp_path):
    cfg, opt, _ = setup
    state = _state(cfg, opt, 0)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5] and ckpt.latest_step(str(tmp_path)) == 5
    _assert_equal_trees(state, ckpt.restore(str(tmp_path), 5, _state(cfg, opt, 9)))
    with open(tmp_path / "step_5" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["step"] == {"shape": [], "dtype": "int32"}
    assert leaves["opt/count"]["dtype"] == "int32"
    assert "opt/mu/blocks/attn/wq/w" in leaves and "err_buf" not in str(sorted(leaves))


def test_async_checkpoint_snapshots_before_returning(setup, tmp_path):
    cfg, opt, _ = setup
    state = _state(cfg, opt, 1)
    want = state.params["embed"].clone()
    h = ckpt.save(str(tmp_path), 7, state, async_save=True)
    state.params["embed"].add_(1.0)          # an in-place step after the save
    h.wait()
    assert ckpt.latest_step(str(tmp_path)) == 7
    got = ckpt.restore(str(tmp_path), 7, state)
    assert torch.equal(got.params["embed"], want)


def test_restore_refuses_missing_and_misshapen_leaves(setup, tmp_path):
    cfg, opt, _ = setup
    state = _state(cfg, opt, 2)
    ckpt.save(str(tmp_path), 1, state.params)
    with pytest.raises(ValueError, match="missing leaves"):
        ckpt.restore(str(tmp_path), 1, state)
    bad = dict(state.params, embed=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, bad)


def test_crash_recovery_bit_exact(setup, tmp_path):
    """10 steps straight == 6 steps, save, "crash", restore into a fresh
    state, 4 more steps."""
    cfg, opt, stream = setup
    step = make_train_step(cfg, opt)
    state = _state(cfg, opt, 2)
    for i in range(10):
        state, _ = step(state, stream.batch(i, device="cpu"))
    straight = state

    state = _state(cfg, opt, 2)
    for i in range(6):
        state, _ = step(state, stream.batch(i, device="cpu"))
    ckpt.save(str(tmp_path), 6, state)
    del state
    state = ckpt.restore(str(tmp_path), 6, _state(cfg, opt, 99))
    for i in range(6, 10):
        state, _ = step(state, stream.batch(i, device="cpu"))
    _assert_equal_trees(straight, state)


def test_run_with_restarts_fault_injection(setup, tmp_path):
    cfg, opt, stream = setup
    step = make_train_step(cfg, opt)
    crashes = {"armed": 2}  # fail twice, then succeed

    def restore_fn():
        latest = ckpt.latest_step(str(tmp_path))
        target = _state(cfg, opt, 0)
        if latest is None:
            return target, 0
        return ckpt.restore(str(tmp_path), latest, target), latest

    def body(state, start):
        for i in range(start, 8):
            if i == 5 and crashes["armed"] > 0:
                crashes["armed"] -= 1
                raise RuntimeError("simulated node failure")
            state, _ = step(state, stream.batch(i, device="cpu"))
            if (i + 1) % 2 == 0:
                ckpt.save(str(tmp_path), i + 1, state)
        return 8

    report = run_with_restarts(body, restore_fn=restore_fn, max_restarts=3)
    assert report.completed and report.restarts == 2 and len(report.failures) == 2
    assert ckpt.latest_step(str(tmp_path)) == 8
    straight = _state(cfg, opt, 0)
    for i in range(8):
        straight, _ = step(straight, stream.batch(i, device="cpu"))
    _assert_equal_trees(straight, ckpt.restore(str(tmp_path), 8, _state(cfg, opt, 1)))


def test_run_with_restarts_gives_up():
    calls = []

    def body(state, start):
        raise RuntimeError("always")

    report = run_with_restarts(body, restore_fn=lambda: calls.append(1) or (None, 3),
                               max_restarts=2)
    assert not report.completed and report.restarts == 3 and report.last_step == 3
    assert len(calls) == 3 and len(report.failures) == 3


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A reference TrainState (float32 moments) saved by the reference
    restores in the port leaf for leaf, bit for bit, with the keys the
    port's TrainState flattens to."""
    cfg, _ = reference_latent(ARCH)
    jstate = jinit_state(cfg, jax.random.PRNGKey(3), JOptConfig())
    jckpt.save(str(tmp_path), 4, jstate)
    target = _state(cfg, OptConfig(), 0)
    got = ckpt.restore(str(tmp_path), 4, target)
    want = {k: np.asarray(v) for k, v in jckpt.checkpointing._flatten(jstate).items()}
    flat = _leaves(got)
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].numpy().tobytes() == v.tobytes() and flat[k].numpy().dtype == v.dtype, k


def test_port_checkpoint_restores_in_the_reference(setup, tmp_path):
    cfg, opt, stream = setup
    state = _state(cfg, opt, 4)
    state, _ = make_train_step(cfg, opt)(state, stream.batch(0, device="cpu"))
    ckpt.save(str(tmp_path), 1, state)
    target = jinit_state(cfg, jax.random.PRNGKey(0), JOptConfig())
    got = jckpt.restore(str(tmp_path), 1, target)
    want = _leaves(state)
    flat = {k: np.asarray(v) for k, v in jckpt.checkpointing._flatten(got).items()}
    assert set(flat) == set(want)
    for k, v in want.items():
        assert flat[k].tobytes() == v.numpy().tobytes(), k
    assert int(got.step) == 1 and int(got.opt.count) == 1


def test_bfloat16_moments_across_packages(tmp_path):
    """The reference's bfloat16 moments restore in the port bit for bit;
    the port writes the same bytes and manifest; the reference restores
    neither file."""
    cfg, jparams = reference_latent(ARCH)
    jopt = JOptConfig(moment_dtype="bfloat16")
    jstate = jinit_state(cfg, jax.random.PRNGKey(0), jopt)
    rng = np.random.default_rng(0)
    mu = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.bfloat16),
                      jstate.opt.mu)
    jstate = jstate._replace(opt=jstate.opt._replace(mu=mu))
    jckpt.save(str(tmp_path / "ref"), 1, jstate.opt)

    params = bridge.params_from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    target = adamw_init(params, torch.bfloat16)
    got = ckpt.restore(str(tmp_path / "ref"), 1, target)
    assert isinstance(got, AdamWState) and got.mu["embed"].dtype == torch.bfloat16
    ref_mu = jax.tree.map(lambda x: np.asarray(x).view(np.int16), mu)
    for (k, w), g in zip(jckpt.checkpointing._flatten(ref_mu).items(),
                         _leaves(got.mu).values()):
        assert np.array_equal(g.view(torch.int16).numpy(), w), k

    ckpt.save(str(tmp_path / "port"), 1, got)
    with open(tmp_path / "ref" / "step_1" / "manifest.json") as f:
        want_manifest = json.load(f)
    with open(tmp_path / "port" / "step_1" / "manifest.json") as f:
        assert json.load(f) == want_manifest
    for name in ("ref", "port"):
        with zipfile.ZipFile(tmp_path / name / "step_1" / "arrays.npz") as z:
            arr = np.lib.format.read_array(z.open("mu/embed.npy"))
        assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2
        assert arr.view(np.int16).tobytes() == ref_mu["embed"].tobytes(), name
        with pytest.raises(ValueError, match="cast"):
            jckpt.restore(str(tmp_path / name), 1, jstate.opt)


def test_raw_leaf_with_another_dtype_is_refused(tmp_path):
    ckpt.save(str(tmp_path), 1, {"m": torch.zeros(4, dtype=torch.bfloat16)})
    path = tmp_path / "step_1" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["leaves"]["m"]["dtype"] = "float16"
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="only bfloat16"):
        ckpt.restore(str(tmp_path), 1, {"m": torch.zeros(4, dtype=torch.bfloat16)})


def test_straggler_detection():
    mon = StepMonitor(window=16, straggler_factor=2.0)
    for i in range(10):
        mon.start(i)
        mon.times.append(0.1)  # synthetic fast steps
    mon.start(99)
    assert mon.is_straggler(0.5)
    assert not mon.is_straggler(0.15)
    assert mon.median() == pytest.approx(0.1)


def test_heartbeat(tmp_path):
    path = os.path.join(str(tmp_path), "hb.json")
    hb = Heartbeat(path, interval_s=0.0)
    hb.beat(step=3)
    assert Heartbeat.is_alive(path, deadline_s=60)
    assert not Heartbeat.is_alive(path + ".missing")


def test_elastic_remesh_plan():
    assert elastic_remesh_plan(512, 16) == (32, 16)
    assert elastic_remesh_plan(496, 16) == (31, 16)  # lost a host: fewer DP
    assert elastic_remesh_plan(16, 16) == (1, 16)
    with pytest.raises(ValueError):
        elastic_remesh_plan(8, 16)
