"""Port vs reference: the training path on the reduced configs, CPU.

Inputs are numpy-seeded and the params are the reference's
(``init_params(PRNGKey(0))``) carried across with the bridge.

* ``loss_fn`` of every family against ``jax.value_and_grad`` of the
  reference's: the loss within 1e-5 relative and every gradient leaf
  within 1e-4 relative L2.  Two kinds of case depart from that, both
  measured on these inputs:

  - the MoE's routed experts run bf16 einsums (the reference's own
    contract, 2^-8 roundoff; ``tests/test_torch_moe.py`` holds their output
    to 1e-2): an input one float32 ulp apart can round a bf16 ulp apart,
    and the gradients then agree within 1e-2 relative L2 (measured 4.5e-3,
    the routed ``w_gate``), the loss within 1e-5;
  - on latent weights the enc-dec and VLM inputs (random frames and
    patches) put one int8 activation code at a rounding tie, which the
    packages round apart (a one-ulp difference of the code's input), and
    the moved code changes the STE forward downstream (measured: loss
    1.1e-5 / 9.3e-5 apart, gradients 5.5e-3 / 6.1e-3).  Those two families
    are held at 1e-5 / 1e-4 on the reference's dense twin of the same
    weights (``{'wd'}``, no quantization), as ``tests/test_torch_encdec_vlm.py``
    holds their encoder; the straight-through forward and backward are the
    same functions in every family.

* ``remat=True`` gives the same loss and gradients as ``remat=False``, bit
  for bit; ``accum_steps=2`` gives the full batch's within 1e-5.
* Four ``make_train_step`` steps of ``bitnet-2b-4t`` in each package, from
  the same params on the same stream, with float32 and with bfloat16
  moments: the loss within 1e-5 relative at every step and every param
  within 1e-4 (absolute) of the reference's (measured: 6.3e-7 and
  4.3e-5).  They run on the dense twin of the weights.  On the latent
  weights a trajectory cannot be held to 1e-4 by any implementation: the
  STE forward moves an int8 code whenever an input sits within an ulp of
  a rounding tie, and AdamW turns a tiny gradient's sign into a full
  step.  Measured there: the reference's own jitted and eager steps are
  4.4e-4 apart in loss and 4.7e-2 (relative) in a norm gain after four
  steps; the port is 1.4e-7 from the eager step after one step, and
  5e-5 apart in loss at the third step even when each step starts from
  the same state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving import one_torch_thread, reference_dense, reference_latent  # noqa: F401

import repro.configs as jconfigs
from repro.models import model_zoo as jzoo
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as jmake_train_step
from repro_torch import bridge
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch import train as train_main
from repro_torch.models import model_zoo
from repro_torch.optim import OptConfig, adamw_init, compression
from repro_torch.train import (TrainState, init_state, loss_and_grads,
                               make_compressed_dp_train_step, make_train_step)
from repro_torch.utils.tree import leaves, tree_map

# Tiny reduced-config ops: one torch thread per test worker (see the fixture).
pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = {
    # arch: (weights, gradient tolerance)
    "bitnet-2b-4t": ("latent", 1e-4),
    "mamba2-780m": ("latent", 1e-4),
    "hymba-1.5b": ("latent", 1e-4),
    "deepseek-moe-16b": ("latent", 1e-2),
    "whisper-tiny": ("dense", 1e-4),
    "llava-next-mistral-7b": ("dense", 1e-4),
}


def _batch(cfg, seed: int = 0, b: int = 2, s: int = 16) -> dict:
    """numpy tokens and labels (a few labels -1, masked), and random frames
    or patches."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return batch


def _port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, path + (k,)).items()}
    return {"/".join(path): np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ref_params(arch: str, kind: str):
    cfg, params = (reference_latent if kind == "latent" else reference_dense)(arch)
    return cfg, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_loss_and_grads_match_reference(arch):
    kind, grad_tol = FAMILIES[arch]
    cfg, ref = _ref_params(arch, kind)
    batch = _batch(cfg)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jzoo.loss_fn(cfg, p, jax.tree.map(jnp.asarray, batch)), has_aux=True)(
        jax.tree.map(jnp.asarray, ref))
    params = bridge.params_from_reference(ref, device="cpu")
    loss, metrics, grads = loss_and_grads(cfg, params, _port_batch(batch))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert abs(float(metrics["aux"]) - float(want_m["aux"])) <= 1e-5 * max(
        abs(float(want_m["aux"])), 1.0)
    got, want = _flat(grads), _flat(want_g)
    assert set(got) == set(want)
    errs = {k: _rel(got[k], want[k]) for k in want}
    assert max(errs.values()) <= grad_tol, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("arch", ["bitnet-2b-4t", "deepseek-moe-16b", "whisper-tiny"])
def test_remat_is_bit_identical(arch):
    cfg, ref = _ref_params(arch, "latent")
    batch = _port_batch(_batch(cfg, seed=1))
    params = bridge.params_from_reference(ref, device="cpu")
    plain = loss_and_grads(cfg, params, batch)
    remat = loss_and_grads(cfg, params, batch, remat=True)
    assert torch.equal(plain[0], remat[0])
    for k, g in _flat(plain[2]).items():
        assert np.array_equal(g, _flat(remat[2])[k]), k


def test_accumulation_matches_full_batch():
    cfg, ref = _ref_params("bitnet-2b-4t", "latent")
    params = bridge.params_from_reference(ref, device="cpu")
    batch = _port_batch(_batch(cfg, seed=2, b=4))
    batch["labels"][0, :3] = 5          # every microbatch scores all its tokens
    full = loss_and_grads(cfg, params, batch)
    split = loss_and_grads(cfg, params, batch, accum_steps=2)
    assert abs(float(split[0]) - float(full[0])) <= 1e-5 * float(full[0])
    want = _flat(full[2])
    for k, g in _flat(split[2]).items():
        assert _rel(g, want[k]) <= 1e-5, k


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_four_train_steps_match_reference(moment_dtype):
    """Four ``make_train_step`` steps in each package from the same params
    on the same stream (module docstring)."""
    cfg, ref = _ref_params("bitnet-2b-4t", "dense")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=4, moment_dtype=moment_dtype)
    jparams = jax.tree.map(jnp.asarray, ref)
    want = JTrainState(jparams, jadamw_init(jparams, jnp.dtype(moment_dtype)),
                       jnp.zeros((), jnp.int32))
    ref_step = jax.jit(jmake_train_step(cfg, JOptConfig(**kw)))
    params = bridge.params_from_reference(ref, device="cpu")
    state = TrainState(params, adamw_init(params, getattr(torch, moment_dtype)),
                       torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg, OptConfig(**kw))
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 32, 4, seed=3))
    for i in range(4):
        want, want_m = ref_step(want, jax.tree.map(jnp.asarray, stream.batch_numpy(i)))
        state, m = step(state, stream.batch(i, device="cpu"))
        assert abs(float(m["loss"]) - float(want_m["loss"])) <= 1e-5 * float(want_m["loss"])
        got = _flat(state.params)
        for k, w in _flat(jax.tree.map(np.asarray, want.params)).items():
            assert np.abs(got[k] - w).max() <= 1e-4, (i, k)
        assert int(state.step) == i + 1 and int(state.opt.count) == i + 1
    assert state.opt.mu["embed"].dtype == getattr(torch, moment_dtype)


def test_non_ternary_config_inits_dense_and_trains():
    """``cfg.ternary=False``: every projection ``{'wd'}`` (the reference's
    layout, routed expert stacks included), and a train step runs."""
    for arch in ("bitnet-2b-4t", "deepseek-moe-16b", "mamba2-780m", "whisper-tiny"):
        cfg = dataclasses.replace(jconfigs.get(arch).reduced(), ternary=False)
        want = jzoo.init_params(cfg, jax.random.PRNGKey(0))
        got = model_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        want_shapes = {k: v.shape for k, v in _flat(want).items()}
        assert {k: tuple(v.shape) for k, v in _flat(got).items()} == want_shapes
        assert not any(k.endswith("/w") for k in want_shapes)
        loss, _, grads = loss_and_grads(cfg, got, _port_batch(_batch(cfg)))
        assert np.isfinite(float(loss))
        assert all(np.isfinite(g).all() for g in _flat(grads).values())


def test_compressed_step_single_process_matches_reference_compression():
    """One process: the gradient mean is the int8 round trip (codes x
    scale, rounded to bf16) with error feedback, as the reference computes
    it over a one-device mesh."""
    cfg, ref = _ref_params("bitnet-2b-4t", "latent")
    params = bridge.params_from_reference(ref, device="cpu")
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    state = TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32),
                       compression.init_error_buffer(params))
    batch = _port_batch(_batch(cfg, seed=4))
    batch["labels"][0, :3] = 5
    _, _, grads = loss_and_grads(cfg, params, batch)
    # psum_compressed writes into its arguments: the reference computation
    # takes copies, so the step below starts from zero error buffers.
    clone = lambda tree: tree_map(torch.clone, tree)  # noqa: E731
    want_g, want_e = compression.psum_compressed(clone(grads), clone(state.err_buf))
    assert all(not e.any() for e in _flat(state.err_buf).values())
    new, m = make_compressed_dp_train_step(cfg, opt)(state, batch)
    assert int(new.step) == 1 and np.isfinite(float(m["loss"]))
    # The step's buffers (written in place) and the reference's are apart.
    assert not any(a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
                   for a, b in zip(leaves(new.err_buf), leaves(want_e)))
    for k, e in _flat(new.err_buf).items():
        assert np.array_equal(e, _flat(want_e)[k]), k
    big = [k for k, g in _flat(grads).items() if g.size >= compression.MIN_COMPRESSED]
    assert big and any(np.abs(_flat(new.err_buf)[k]).max() > 0 for k in big)


def test_init_state_defaults_to_the_gpu():
    cfg = jconfigs.get("bitnet-2b-4t").reduced()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg, torch.Generator(), OptConfig())


def test_launch_train_smoke_and_resume(tmp_path, capsys):
    """``launch/train.py --smoke --device cpu``: 4 steps with a checkpoint
    every 2, then a second run to 6 resumes from step 4; ``--compress-grads``
    runs in one process; ``--fsdp`` without a mesh is accepted and has no
    effect, as in the reference; ``--mesh single`` on a world of one raises,
    naming both sizes (across processes: ``test_torch_distributed``)."""
    args = ["--arch", "bitnet-2b-4t", "--smoke", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "2", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    assert train_main.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "completed=True restarts=0 last_step=4" in out
    ckdir = tmp_path / jconfigs.get("bitnet-2b-4t").reduced().name
    assert sorted(p.name for p in ckdir.iterdir() if p.name.startswith("step_")) == [
        "step_2", "step_4"]
    assert train_main.main(args + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "resuming from step 4" in out and "last_step=6" in out
    compressed = args[:-1] + [str(tmp_path / "compressed"), "--steps", "2",
                              "--compress-grads"]
    assert train_main.main(compressed) == 0
    assert "completed=True restarts=0 last_step=2" in capsys.readouterr().out
    fsdp = args[:-1] + [str(tmp_path / "fsdp"), "--steps", "1", "--fsdp"]
    assert train_main.main(fsdp) == 0
    assert "completed=True restarts=0 last_step=1" in capsys.readouterr().out
    with pytest.raises(ValueError, match=r"256-process .* 1 processes"):
        train_main.main(args + ["--steps", "1", "--mesh", "single"])
