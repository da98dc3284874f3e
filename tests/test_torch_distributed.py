"""Port vs reference: execution across processes, on gloo ranks on the CPU.

The port's ranks are spawned processes joined through a file in the
test's directory (``tests/_torch_dist.py``); the reference runs once per
module in its own process on four host devices
(``tests/_jax_mesh_ref.py``), started first and read when a test needs it,
from the same numpy-seeded params and batches.

* placement: on a (2, 2) mesh, fsdp on and off, every rank's local shard
  of every leaf of reduced bitnet-2b-4t and deepseek-moe-16b equals the
  slice the reference's ``NamedSharding`` gives that device, and the view
  ``sharding.local_shard`` takes of the full leaf;
* ``psum_compressed`` on 2 and 4 ranks: outputs ``array_equal`` to the
  reference's ``shard_map``; error buffers within 2^-20 (compiled, XLA
  fuses ``target - q * scale`` into one multiply-add); tiny leaves (a
  float32 mean) within one float32 ulp;
* the compressed data-parallel step on 2 ranks: the first step's loss
  within 1e-5 of the reference's on 2 devices, the exchanged mean gradient
  within 1e-3 relative L2; a second step runs with the error buffers
  carried (its loss not held tightly: free-running AdamW steps drift);
* ``jit_train_step`` on (2, 2), fsdp on and off: the loss within 1e-4 of
  the port's one-process step and of the reference's unsharded one; within
  1e-4 of the reference's sharded step for bitnet, and for the MoE within
  1e-4 plus the reference's own sharded-vs-unsharded gap (6.7e-4 measured:
  XLA's partitioned bf16 expert sums), printed beside it; the averaged
  gradients within 1e-3 relative L2 of the one-process step's (MoE 1e-2:
  bf16 experts); the state back in its placements; the MoE step keeps its
  routed experts split on 'model' (never all-gathered there), moves the
  tokens by two all-to-alls per MoE layer forward, and each rank's shard of
  an expert gradient is within 1e-2 of its slice of the one-process one;
* checkpoints: saved from 4 ranks, restored onto 2 ranks and onto 1,
  equal leaf by leaf;
* ``launch/train.py``: ``--compress-grads`` on 2 ranks completes and
  resumes; the mesh path steps through ``jit_train_step`` on 2 ranks (the
  production mesh swapped for a (1, 2) one); ``--mesh single`` on a world
  of one raises, naming 256 and 1.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_dist import (compressed_dp_rank, flat, jit_step_rank, lm_batch, port_params,
                         psum_rank, reduced, restore_rank, run_ranks, train_cli_rank,
                         train_mesh_rank)
from _torch_serving import one_torch_thread  # noqa: F401

from repro_torch import checkpoint as ckpt
from repro_torch.launch import train as train_main
from repro_torch.optim import OptConfig
from repro_torch.train import init_state

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCHS = ("bitnet-2b-4t", "deepseek-moe-16b")
CASES = tuple((a, f) for a in ARCHS for f in (False, True))
HERE = os.path.dirname(os.path.abspath(__file__))


def _psum_inputs(n: int) -> tuple:
    """Per-rank grads and error buffers: a large leaf (padded: 3001 is no
    multiple of 2 or 4), a (64, 64) leaf and a tiny one."""
    rng = np.random.default_rng(n)
    grads = {"big": rng.standard_normal((n, 3001)).astype(np.float32),
             "mat": rng.standard_normal((n, 64, 64)).astype(np.float32),
             "tiny": rng.standard_normal((n, 7)).astype(np.float32)}
    errs = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32)
            for k, v in grads.items()}
    errs["tiny"][:] = 0
    return grads, errs


# The tests that need no reference come first: the reference's process runs
# meanwhile.

class _Reference:
    """The reference's process, started at module set-up and read on first
    use."""

    def __init__(self, workdir):
        self.params = {a: flat(port_params(a)) for a in ARCHS}
        self.psum_inputs = {n: _psum_inputs(n) for n in (2, 4)}
        cfg = reduced("bitnet-2b-4t")
        self.compressed_batches = [lm_batch(cfg, 4, 16, s) for s in (10, 11)]
        self.sharded_batch = {a: lm_batch(reduced(a), 4, 16, 0) for a in ARCHS}
        job = {"archs": ARCHS, "params": self.params, "psum": self.psum_inputs,
               "compressed_arch": "bitnet-2b-4t",
               "compressed_batches": [_np(b) for b in self.compressed_batches],
               "sharded_cases": CASES,
               "sharded_batch": {a: _np(b) for a, b in self.sharded_batch.items()}}
        self.inp, self.out = os.path.join(workdir, "in.pkl"), os.path.join(workdir, "out.pkl")
        with open(self.inp, "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.log = open(os.path.join(workdir, "ref.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_jax_mesh_ref.py"), self.inp, self.out],
            env=env, stdout=self.log, stderr=subprocess.STDOUT)
        self._res = None

    def get(self) -> dict:
        if self._res is None:
            rc = self.proc.wait(timeout=480)
            self.log.close()
            if rc != 0:
                raise RuntimeError("reference process failed:\n"
                                   + open(self.log.name).read()[-4000:])
            with open(self.out, "rb") as f:
                self._res = pickle.load(f)
        return self._res

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def _np(batch: dict) -> dict:
    return {k: v.numpy().astype(np.int32) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = _Reference(str(tmp_path_factory.mktemp("jax_mesh_ref")))
    yield r
    r.close()


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def _cli_args(ckdir) -> list:
    return ["--arch", "bitnet-2b-4t", "--smoke", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "4", "--ckpt-every", "2", "--ckpt-dir", str(ckdir)]


def test_launch_train_compressed_over_two_ranks_resumes(tmp_path):
    args = _cli_args(tmp_path) + ["--compress-grads"]
    assert run_ranks(train_cli_rank, 2, tmp_path, args + ["--steps", "2"]) == [0, 0]
    assert run_ranks(train_cli_rank, 2, tmp_path, args + ["--steps", "4"]) == [0, 0]
    ckdir = tmp_path / reduced("bitnet-2b-4t").name
    assert sorted(p.name for p in ckdir.iterdir() if p.name.startswith("step_")) == [
        "step_2", "step_4"]


def test_launch_train_mesh_steps_through_jit_train_step(tmp_path):
    """``--mesh single --fsdp`` with the production mesh swapped for a
    (1, 2) one over 2 ranks: steps, checkpoints and resumes."""
    args = _cli_args(tmp_path) + ["--mesh", "single", "--fsdp"]
    first = run_ranks(train_mesh_rank, 2, tmp_path, args + ["--steps", "2"])
    assert [r["rc"] for r in first] == [0, 0] and all(r["jit_steps"] == 2 for r in first)
    again = run_ranks(train_mesh_rank, 2, tmp_path, args + ["--steps", "4"])
    assert [r["rc"] for r in again] == [0, 0] and all(r["jit_steps"] == 2 for r in again)


def test_launch_train_mesh_needs_its_world(tmp_path):
    with pytest.raises(ValueError, match=r"256-process .* 1 processes"):
        train_main.main(_cli_args(tmp_path) + ["--mesh", "single", "--steps", "1"])
    with pytest.raises(ValueError, match=r"512-process .* 1 processes"):
        train_main.main(_cli_args(tmp_path) + ["--mesh", "multi", "--steps", "1"])


# ---------------------------------------------------------------------------
# jit_train_step and the checkpoints of its sharded state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_runs(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("jit_step")
    outs = run_ranks(jit_step_rank, 4, d, ARCHS, CASES, ref.params, ref.sharded_batch,
                     str(d / "ck"))
    return outs, str(d / "ck")


@pytest.mark.parametrize("arch,fsdp", CASES)
def test_jit_train_step_matches_one_process_and_reference(ref, sharded_runs, arch, fsdp):
    outs, _ = sharded_runs
    res = outs[0][arch, fsdp]
    want = ref.get()["sharded"][arch, fsdp]
    print(f"{arch} fsdp={fsdp}: port sharded {res['loss']:.7f}, port one-process "
          f"{res['loss_one']:.7f}, reference sharded {want['loss']:.7f}, reference "
          f"unsharded {want['unsharded_loss']:.7f} (the reference's own gap "
          f"{abs(want['loss'] - want['unsharded_loss']):.2e})")
    assert {o[arch, fsdp]["loss"] for o in outs} == {res["loss"]}
    assert res["sharded_grads_loss"] == res["loss"]
    assert abs(res["loss"] - res["loss_one"]) <= 1e-4
    assert abs(res["loss"] - want["unsharded_loss"]) <= 1e-4
    # The reference's sharded MoE step is 6.7e-4 from its own unsharded one
    # (its bf16 expert sums follow XLA's partitioning); the port's sharded
    # step keeps the one-process sums, so it is held to the reference's
    # sharded loss within that gap (bitnet's gap: 3.4e-6).
    gap = abs(want["loss"] - want["unsharded_loss"])
    assert abs(res["loss"] - want["loss"]) <= 1e-4 + gap
    if arch == "bitnet-2b-4t":
        assert abs(res["loss"] - want["loss"]) <= 1e-4
    tol = 1e-2 if arch == "deepseek-moe-16b" else 1e-3
    for k, g in res["grads_one"].items():
        assert _rel(res["grads"][k], g) <= tol, k
    assert all(o[arch, fsdp]["same_placements"] for o in outs)


@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_moe_step_moves_tokens_not_experts(sharded_runs, fsdp):
    """Reduced deepseek-moe-16b on (2, 2): 4 routed experts, 2 per 'model'
    rank.  No rank all-gathers an expert stack over 'model'; each MoE
    layer's forward runs two all-to-alls (tokens out to the experts' ranks
    and back); every rank's shard of each routed-expert gradient is within
    1e-2 relative L2 of its slice of the one-process gradient.  The dense
    model runs no all-to-all."""
    outs, _ = sharded_runs
    cfg = reduced("deepseek-moe-16b")
    for rank, o in enumerate(outs):
        res = o["deepseek-moe-16b", fsdp]
        assert res["expert_gathers_over_model"] == [], rank
        assert res["all_to_all"] == 2 * cfg.n_layers, rank
        assert sorted(res["expert_shard_rel"]) == [
            f"blocks/moe/{w}/w" for w in ("w_down", "w_gate", "w_up")]
        for key, rel in res["expert_shard_rel"].items():
            assert rel <= 1e-2, (rank, key, rel)
        assert o["bitnet-2b-4t", fsdp]["all_to_all"] == 0


def test_fsdp_step_gathers_one_layer_at_a_time(sharded_runs):
    """``jit_train_step(fsdp=True)``'s gradients on (2, 2), 4-layer reduced
    bitnet-2b-4t: with and without ``remat`` the whole params alive at once
    are never more than the params outside the layer stack plus one
    layer's, well below all of them (a layer's whole latent weights are
    dropped when the layer is done: the straight-through forward keeps its
    ternarized weights for the backward, not the latent ones).  The
    gradients come back shard-sized."""
    for o in sharded_runs[0]:
        live = o["liveness"]
        assert live["top"] + live["layer"] < live["all"] / 2, live
        for remat in (True, False):
            assert 0 < live[remat] <= live["top"] + live["layer"], (remat, live)
        assert live["shard_shapes"]


@pytest.mark.parametrize("world", [2, 1])
def test_checkpoint_from_four_ranks_restores_elsewhere(sharded_runs, tmp_path, world):
    """Saved from the (2, 2) fsdp state; restored onto a (1, 2) mesh (2
    ranks, placed by that mesh's specs) and onto one process."""
    outs, ck = sharded_runs
    saved = outs[0]["saved"]
    if world == 1:
        cfg = reduced("bitnet-2b-4t")
        target = init_state(cfg, torch.Generator().manual_seed(1), OptConfig(), device="cpu")
        got = flat(ckpt.restore(ck, 1, target).params)
    else:
        res = run_ranks(restore_rank, 2, tmp_path, ck)
        got = res[0]["params"]
        assert res[1]["params"].keys() == got.keys()
        assert any(p != "Replicate()" for _, pl in res[0]["placements"] for p in map(str, pl))
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(torch.from_numpy(got[k]), torch.from_numpy(v)), k


# ---------------------------------------------------------------------------
# The compressed all-reduce and the compressed data-parallel step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_psum_compressed_equals_reference(ref, tmp_path, n):
    grads, errs = ref.psum_inputs[n]
    got = run_ranks(psum_rank, n, tmp_path, grads, errs)
    want_g, want_e = ref.get()["psum"][n]
    for rank in range(n):
        g, e = got[rank]
        for k in ("big", "mat"):
            np.testing.assert_array_equal(g[k], want_g[k][rank], err_msg=f"{k} rank {rank}")
            np.testing.assert_allclose(e[k], want_e[k][rank], rtol=0, atol=2.0 ** -20,
                                       err_msg=f"{k} rank {rank}")
        tiny = want_g["tiny"][rank]
        np.testing.assert_allclose(g["tiny"], tiny, rtol=0,
                                   atol=float(np.max(np.spacing(np.abs(tiny)))))
        np.testing.assert_array_equal(e["tiny"], want_e["tiny"][rank])


def test_compressed_dp_step_matches_reference(ref, tmp_path):
    arch = "bitnet-2b-4t"
    got = run_ranks(compressed_dp_rank, 2, tmp_path, arch, ref.params[arch],
                    ref.compressed_batches)
    want = ref.get()["compressed"]
    assert got[0]["losses"] == got[1]["losses"]
    assert abs(got[0]["losses"][0] - want["losses"][0]) <= 1e-5, (got[0], want["losses"])
    assert np.isfinite(got[0]["losses"][1])
    for k, w in want["mean_grads"].items():
        assert _rel(got[0]["mean_grads"][k], w) <= 1e-3, k
        np.testing.assert_array_equal(got[0]["mean_grads"][k], got[1]["mean_grads"][k])


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def test_placement_matches_reference_device_slices(ref, sharded_runs):
    shards = [o["shards"] for o in sharded_runs[0]]
    assert all(s["local_shard_differs"] == [] for s in shards)
    want = ref.get()["placements"]
    for arch, fsdp in CASES:
        full, maps = ref.params[arch], want[arch, fsdp]
        assert set(maps) == set(full)
        for key, leaf in full.items():
            for rank in range(4):
                idx = tuple(slice(a, b) for a, b in maps[key][rank])
                np.testing.assert_array_equal(shards[rank][arch, fsdp][key], leaf[idx],
                                              err_msg=f"{arch} fsdp={fsdp} {key} rank {rank}")
