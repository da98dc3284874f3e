"""The dry-run per device on a mesh: each cell traced as rank 0 of a fake
world (``launch.mesh.fake_world``) on the meta device.

* hand counts, exact: one packed projection on a (1, 2) mesh, row-parallel
  (the absmax MAX and the int32 partials SUM all-reduced) and
  column-parallel (no collective), and an FSDP-gathered leaf on (2, 1)
  (all-gather of the whole, reduce-scatter of the gradient's shard); an
  all-to-all counts its output's bytes, forward and backward; bytes
  accessed: one mm's inputs plus its output, nothing for a view or an
  allocation, and a packed projection's kernel call its operands and
  output;
* the fake world against real ranks, exact: on (2, 2), reduced bitnet-2b-4t
  decode and prefill, deepseek-moe-16b decode (the expert-parallel branch),
  the train cell with fsdp on and off, deepseek-moe-16b's fsdp train cell
  (experts kept on 'model', tokens by all-to-all) and a one-KV-head bitnet
  decode (the cache split on its sequence: split-KV); the dry-run's FLOPs,
  kernel tally and collective bytes of each kind on a fake world of gloo's
  device type equal the same counter around each rank of a real gloo run
  of the same step (``tests/_torch_dist.py``); on the H100's device type
  the counts are the same but that DTensor's re-sharding all-to-all
  replaces gloo's all-gather and chunk;
* the same cell traced twice in one process, another between, gives equal
  records; the fake group is gone after ``run_cell``, a real one is never
  replaced, and a failure is a record with ``status: "error"``;
* uneven splits: the fake world takes any rank; a cell whose dims all
  divide is traced once with rank 0's counts as they are; full-width
  bitnet-2b-4t train_4k on 2 x 16 x 16 (8 rows of a data slice over 16
  'model' ranks) records rank 0 and rank 511 and the larger of each term;
  full-width qwen3-32b prefill_32k keeps its query heads split (each rank
  its 4 of 64 against their one KV head): bytes accessed per device at
  most a tenth of what the replicated branch counted;
* against the reference on four host devices in a subprocess
  (``tests/_jax_dryrun_ref.py``): per-device argument bytes on (2, 2) equal
  XLA's but for the frozen ``density`` leaves a serve step never reads
  (``jax.jit`` prunes unused arguments); the collective bytes by kind of
  both are printed, not held (XLA's partitioner picks other collectives
  than the port's explicit ones).
"""
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from _torch_dist import DRYRUN_CELLS, dryrun_counts_rank, fake_world_counts, reduced, run_ranks
from _torch_serving import one_torch_thread  # noqa: F401

import repro_torch.configs as configs
from repro_torch.kernels import tally
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import layers, model_zoo
from repro_torch.serving import freeze_params
from repro_torch.train import sharding
from repro_torch.train.fsdp import Split

HERE = os.path.dirname(os.path.abspath(__file__))
MESH22 = make_mesh((2, 2), ("data", "model"))

# ---------------------------------------------------------------------------
# Hand counts
# ---------------------------------------------------------------------------

def _projection(name: str, n: int, k: int, m: int):
    """Rank 0's collectives and kernel tally of one packed projection
    ``name`` (K x M) on (1, 2), x (N, K) replicated."""
    mesh = make_mesh((1, 2), ("data", "model"))
    with fake_world(mesh) as dm:
        tree = freeze_params({"attn": {name: {"w": torch.empty((k, m), device="meta")}}})
        placed = sharding.place(tree, dm, sharding.param_specs(tree, dm))["attn"][name]
        x = torch.empty((n, k), device="meta")
        trace = dryrun.MetaTrace(set())
        del tally.TALLY[:]
        with trace:
            y = layers.linear(placed, x, train=False)
        calls = list(tally.TALLY)
        del tally.TALLY[:]
    return trace.collectives, calls, y


def test_row_parallel_projection_hand_count():
    """K on 'model': the per-row absmax (N x 1 float32) and the int32
    partial sums (N x M, as float32) are all-reduced; each rank's kernel
    call has half of K."""
    n, k, m = 4, 256, 96
    coll, calls, y = _projection("wo", n, k, m)
    assert coll == {"all-reduce": 4 * n + 4 * n * m}
    kb = n * k // 2 + 4 * n + 2 * (k // 16) * m + 4 * m + 4 * n * m
    assert calls == [tally.KernelCall("tsar_matmul", n, k // 2, m, 2 * n * (k // 2) * m, kb)]
    assert tuple(y.shape) == (n, m)


def test_column_parallel_projection_hand_count():
    """M on 'model': no collective; each rank's call has half of M."""
    n, k, m = 4, 256, 96
    coll, calls, y = _projection("wq", n, k, m)
    assert coll == {}
    kb = n * k + 4 * n + 2 * (k // 8) * (m // 2) + 4 * (m // 2) + 4 * n * (m // 2)
    assert calls == [tally.KernelCall("tsar_matmul", n, k, m // 2, 2 * n * k * (m // 2), kb)]
    assert tuple(y.shape) == (n, m)


def test_fsdp_leaf_hand_count():
    """A leaf sharded on 'data' of (2, 1), gathered at use by ``Split``:
    the forward all-gathers the whole leaf, the backward reduce-scatters
    its gradient into this rank's shard."""
    mesh = make_mesh((2, 1), ("data", "model"))
    k, m = 64, 48
    with fake_world(mesh) as dm:
        full = {"w": torch.empty((k, m), device="meta")}
        placed = sharding.place(full, dm, {"w": ("data", None)})
        split = Split(dm, {"w": tuple(placed["w"].placements)})
        local = placed["w"].to_local().detach().requires_grad_(True)
        trace = dryrun.MetaTrace(set())
        with trace:
            whole = split.gather({"w": local})["w"]
            whole.sum().backward()
    assert tuple(whole.shape) == (k, m) and tuple(local.grad.shape) == (k // 2, m)
    assert trace.collectives == {"all-gather": 4 * k * m, "reduce-scatter": 4 * k * m // 2}


def test_all_to_all_hand_count():
    """``Split.exchange`` (the MoE dispatch of the sharded train step) on
    (1, 2): an all-to-all of the output's bytes, and another in the
    backward."""
    mesh = make_mesh((1, 2), ("data", "model"))
    with fake_world(mesh) as dm:
        split = Split(dm, {"moe": {"w_gate": {"w": tuple(sharding.placements(
            dm, ("model", None, None), 3))}}})
        x = torch.empty((2, 3, 5, 8), device="meta", requires_grad=True)
        trace = dryrun.MetaTrace(set())
        with trace:
            y = split.exchange(x)
            assert trace.collectives == {"all-to-all": 4 * 2 * 3 * 5 * 8}
            y.sum().backward()
    assert split.ep_size == 2 and tuple(y.shape) == (2, 3, 5, 8)
    assert trace.collectives == {"all-to-all": 2 * 4 * 2 * 3 * 5 * 8}


def test_bytes_accessed_hand_count():
    """Each local op's tensor inputs plus its outputs: an mm, nothing for a
    view or an allocation; a packed projection's kernel call adds its
    operands and output to the tally (the bytes ``chip_smoke.py``'s bound
    moves), and ``measure`` sums both."""
    a, b = torch.empty((4, 8), device="meta"), torch.empty((8, 3), device="meta")
    trace = dryrun.MetaTrace(set())
    with trace:
        c = a @ b
        c.t()
        c.view(3, 4)
        torch.empty((100,), device="meta")
    assert trace.bytes_accessed == 4 * (4 * 8 + 8 * 3 + 4 * 3)
    n, k, m = 4, 256, 96
    _, calls, _ = _projection("wq", n, k, m)
    assert calls[0].nbytes == n * k + 4 * n + 2 * (k // 8) * (m // 2) + 4 * (m // 2) \
        + 4 * n * (m // 2)


def test_unknown_collective_raises():
    """A collective the trace has no kind for is an error, never a byte
    count of 0."""
    with fake_world(make_mesh((1, 2), ("data", "model"))):
        t = torch.empty((8,), device="meta")
        trace = dryrun.MetaTrace(set())
        with trace:
            dist.all_reduce(t)
            with pytest.raises(RuntimeError, match="does not know the collective"):
                dist.broadcast(t, 0)
    assert trace.collectives == {"all-reduce": 32}


# ---------------------------------------------------------------------------
# The fake world against real gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_ranks(tmp_path_factory):
    """Each rank's counts of every cell, from one run of four gloo ranks."""
    return run_ranks(dryrun_counts_rank, 4, tmp_path_factory.mktemp("dryrun_ranks"),
                     DRYRUN_CELLS)


@pytest.mark.parametrize("name", sorted(DRYRUN_CELLS))
def test_fake_world_equals_real_ranks(one_torch_thread, real_ranks, name):  # noqa: F811
    """Gloo's device type: FLOPs, kernel tally and collective bytes of each
    kind equal rank 0's on real ranks, exactly (every rank's collectives
    are rank 0's)."""
    got = fake_world_counts(name, "cpu")
    real = dict(real_ranks[0][name])
    ep_calls = real.pop("ep_calls")
    assert got == real
    assert all(r[name]["collectives"] == real["collectives"] for r in real_ranks)
    assert got["flops"] > 0 and got["collectives"]
    assert ep_calls == (2 if name == "moe_decode" else 0)      # 2 MoE layers, one call each
    # The sharded MoE train step moves tokens, never the expert stacks.
    assert ("all-to-all" in got["collectives"]) == (name == "moe_train_fsdp")
    if "train" in name:
        assert got["collectives"]["all-gather"] > 0 and got["collectives"]["reduce-scatter"] > 0
    else:
        arch, _, _, overrides = DRYRUN_CELLS[name]
        assert got["kernels"]["tsar_matmul"] == 7 * reduced(arch, **overrides).n_layers


@pytest.mark.parametrize("name", sorted(DRYRUN_CELLS))
def test_last_rank_of_fake_world_equals_real_last_rank(one_torch_thread, real_ranks,  # noqa: F811
                                                       name):
    """The dry-run's second trace of an uneven cell: rank 3 of the fake
    world counts what rank 3 of the real gloo ranks counts."""
    real = dict(real_ranks[3][name])
    real.pop("ep_calls")
    assert fake_world_counts(name, "cpu", rank=3) == real


@pytest.mark.parametrize("name", sorted(DRYRUN_CELLS))
def test_device_types_differ_in_the_all_to_all_only(one_torch_thread, name):  # noqa: F811
    """The H100's device type (the dry-run's) against gloo's: the same
    FLOPs, tally, all-reduces and reduce-scatters; where DTensor moves a
    split from one dimension to another, the card does one all-to-all
    (output: the new shard) and gloo an all-gather (the whole, over the
    'model' axis of 2) and a chunk."""
    cuda, cpu = fake_world_counts(name, "cuda"), fake_world_counts(name, "cpu")
    cc, gc = dict(cuda.pop("collectives")), dict(cpu.pop("collectives"))
    # The MoE train step's own dispatch is an all-to-all on both.
    dispatch = gc.pop("all-to-all", 0.0)
    assert cuda == cpu and (dispatch > 0) == (name == "moe_train_fsdp")
    a2a = cc.pop("all-to-all", 0.0) - dispatch
    assert gc.pop("all-gather", 0.0) == cc.pop("all-gather", 0.0) + 2 * a2a
    assert gc == cc
    assert (a2a > 0) == ("train" not in name)     # the vocab-sharded embedding's gather


# ---------------------------------------------------------------------------
# Order independence and the fake world's lifecycle
# ---------------------------------------------------------------------------

def _cell(name: str, mesh=MESH22) -> dict:
    arch, fields, kw, overrides = DRYRUN_CELLS[name]
    rec = dryrun.run_cell(reduced(arch, **overrides), configs.ShapeConfig(*fields), mesh,
                          "2x2", verbose=False, **kw)
    assert rec["status"] == "ok", rec.get("error")
    return {k: v for k, v in rec.items() if k != "wall_s"}


def test_counts_do_not_depend_on_what_ran_before(one_torch_thread):  # noqa: F811
    """DTensor's sharding propagation runs global-shape ops on a cache miss
    only; they are not counted, so a cell traced again after another gives
    the same record, and no process group is left behind."""
    first = _cell("bitnet_decode")
    assert not dist.is_initialized()
    _cell("moe_decode")
    _cell("bitnet_train_fsdp")
    assert _cell("bitnet_decode") == first
    assert first["chips"] == 4 and first["roofline"]["collective_bytes_per_device"] > 0
    assert not dist.is_initialized()


def test_real_group_is_never_replaced(tmp_path):
    """With a process group initialized, a cell on a mesh larger than
    1 x 1 is an error record and the group stays; a 1 x 1 cell needs no
    world and runs."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        arch, fields, _, _ = DRYRUN_CELLS["bitnet_decode"]
        cfg, shape = configs.get(arch).reduced(), configs.ShapeConfig(*fields)
        rec = dryrun.run_cell(cfg, shape, MESH22, "2x2", verbose=False)
        assert rec["status"] == "error" and "would replace it" in rec["error"]
        assert "roofline" not in rec
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        one = dryrun.run_cell(cfg, shape, make_mesh((1, 1), ("data", "model")), "1x1",
                              verbose=False)
        assert one["status"] == "ok"
    finally:
        dist.destroy_process_group()


def test_failure_is_an_error_record(monkeypatch):
    """A step that fails inside the fake world: ``status: "error"`` with
    the reason, no roofline (never an ideal split), no group left."""
    def broken(lowered, mesh):
        raise RuntimeError("sharded op failed")

    monkeypatch.setattr(dryrun, "measure", broken)
    arch, fields, _, _ = DRYRUN_CELLS["bitnet_decode"]
    rec = dryrun.run_cell(configs.get(arch).reduced(), configs.ShapeConfig(*fields), MESH22,
                          "2x2", verbose=False)
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: sharded op failed"
    assert "roofline" not in rec and not dist.is_initialized()


# ---------------------------------------------------------------------------
# Uneven splits: the last rank traced too; the query heads' split kept
# ---------------------------------------------------------------------------

def test_fake_world_takes_any_rank():
    with fake_world(MESH22, rank=3) as dm:
        assert dist.get_rank() == 3 and tuple(dm.get_coordinate()) == (1, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="outside"):
        with fake_world(MESH22, rank=4):
            pass
    assert not dist.is_initialized()


def test_even_cell_is_traced_once(one_torch_thread, monkeypatch):  # noqa: F811
    """Every dim of the cell divides its axes: one trace, rank 0's, and the
    record holds its counts as they are, with no ``uneven`` or ``ranks``."""
    traced = []
    trace_rank = dryrun._trace_rank

    def counted(cfg, shape, mesh, rank, weights, kw):
        traced.append(rank)
        return trace_rank(cfg, shape, mesh, rank, weights, kw)

    monkeypatch.setattr(dryrun, "_trace_rank", counted)
    rec = _cell("bitnet_decode")
    assert traced == [0]
    assert "uneven" not in rec and "ranks" not in rec
    arch, fields, kw, overrides = DRYRUN_CELLS["bitnet_decode"]
    with fake_world(MESH22) as dm:
        lowered, meta = dryrun.lower_cell(reduced(arch, **overrides),
                                          configs.ShapeConfig(*fields), MESH22,
                                          device_mesh=dm, **kw)
        m = dryrun.measure(lowered, MESH22)
    assert meta["uneven"] == []
    assert rec["cost"] == m["counts"] and rec["memory_analysis"] == m["memory_analysis"]
    assert rec["kernels"] == m["kernels"]


def test_uneven_train_cell_records_both_ranks(one_torch_thread):  # noqa: F811
    """Full-width bitnet-2b-4t train_4k on 2 x 16 x 16: 256 rows give 8 per
    data slice, which do not split over 16 'model' ranks.  Rank 0 and rank
    511 are both traced and recorded; each term of the record is the
    larger of the two."""
    rec = dryrun._run_job(("bitnet-2b-4t", "train_4k", "multi", "packed", {}))
    assert rec["status"] == "ok", rec.get("error")
    assert rec["uneven"] == ["batch: 8 rows of a data slice over 16"]
    assert sorted(rec["ranks"]) == ["0", "511"]
    ranks = list(rec["ranks"].values())
    for part, key in (("memory_analysis", "temp_size_in_bytes"), ("counts", "flops"),
                      ("counts", "bytes accessed")):
        want = max(r[part][key] for r in ranks)
        assert (rec["cost"] if part == "counts" else rec[part])[key] == want > 0
    coll = {k for r in ranks for k in r["collectives"]}
    assert rec["roofline"]["collectives"] == {
        k: max(r["collectives"].get(k, 0.0) for r in ranks) for k in coll}


def test_qwen3_prefill_attends_its_own_heads(one_torch_thread):  # noqa: F811
    """Full-width qwen3-32b prefill_32k on 16 x 16: 64 query heads split
    over 'model', 8 KV heads do not.  Each rank attends its 4 query heads
    against their one KV head, so the per-device bytes accessed fall to at
    most a tenth of the 868,199.7 GB the replicated branch counted (about
    a sixteenth: attention's float64 score tiles dominate)."""
    rec = dryrun._run_job(("qwen3-32b", "prefill_32k", "single", "packed", {}))
    assert rec["status"] == "ok", rec.get("error")
    assert "ranks" not in rec
    assert rec["cost"]["bytes accessed"] <= 868_199.7e9 / 10


# ---------------------------------------------------------------------------
# Against XLA on four host devices
# ---------------------------------------------------------------------------

XLA_CELLS = {  # name: (arch, shape fields, weights, fsdp)
    "bitnet_decode": ("bitnet-2b-4t", ("d", 32, 4, "decode"), "packed", True),
    "bitnet_prefill": ("bitnet-2b-4t", ("p", 32, 4, "prefill"), "packed", True),
    "moe_decode": ("deepseek-moe-16b", ("d", 32, 4, "decode"), "packed", True),
    "gemma2_decode": ("gemma2-2b", ("d", 64, 4, "decode"), "packed", True),
    "bitnet_train": ("bitnet-2b-4t", ("t", 32, 4, "train"), "latent", False),
    "bitnet_train_fsdp": ("bitnet-2b-4t", ("t", 32, 4, "train"), "latent", True),
    "gemma2_train": ("gemma2-2b", ("t", 64, 4, "train"), "packed", True),
}


@pytest.fixture(scope="module")
def xla(tmp_path_factory):
    work = tmp_path_factory.mktemp("jax_dryrun_ref")
    inp, out = os.path.join(work, "cells.json"), os.path.join(work, "out.json")
    with open(inp, "w") as f:
        json.dump(XLA_CELLS, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, os.path.join(HERE, "_jax_dryrun_ref.py"), inp, out],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _density_bytes(tree, specs, path=()) -> list:
    """(path, bytes of one device's shard on (2, 2)) of every frozen
    ``density`` leaf."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _density_bytes(v, specs[k], path + (k,))]
    if path[-1] != "density":
        return []
    return [("/".join(path), sharding.shard_bytes(MESH22, tree, specs))]


@pytest.mark.parametrize("name", sorted(XLA_CELLS))
def test_argument_bytes_per_device_equal_xla(one_torch_thread, xla, name):  # noqa: F811
    """Per-device argument bytes on (2, 2) equal XLA's, but for the
    ``density`` leaves of the frozen projections (their shards: the expert
    stacks' ``(L, E)`` densities follow the row-parallel rule onto
    'model'), which a serve step never reads and ``jax.jit`` prunes; the
    collectives of both are printed."""
    arch, fields, weights, fsdp = XLA_CELLS[name]
    cfg, shape = configs.get(arch).reduced(), configs.ShapeConfig(*fields)
    rec = dryrun.run_cell(cfg, shape, MESH22, "2x2", weights=weights, verbose=False, fsdp=fsdp)
    assert rec["status"] == "ok", rec.get("error")
    pruned = []
    if shape.kind != "train":
        params = freeze_params(model_zoo.param_specs(cfg))
        specs = sharding.param_specs(params, MESH22,
                                     fsdp=dryrun.serve_fsdp(cfg, MESH22, weights))
        pruned = _density_bytes(params, specs)
        ffn = (("moe", ("w_down", "w_gate", "w_up")), ("moe/shared", ("w_down", "w_gate", "w_up"))
               ) if cfg.family == "moe" else (("mlp", ("w_down", "w_gate", "w_up")),)
        assert sorted(p for p, _ in pruned) == sorted(
            f"blocks/{blk}/{w}/density" for blk, ws in (("attn", ("wk", "wo", "wq", "wv")),) + ffn
            for w in ws)
    got = rec["memory_analysis"]["argument_size_in_bytes"]
    assert got - sum(b for _, b in pruned) == xla[name]["argument_size_in_bytes"]
    print(f"{name}: collective bytes per device, port {rec['roofline']['collectives']}, "
          f"XLA {xla[name]['collectives']}")
