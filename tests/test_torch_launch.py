"""Port vs reference: the launch layer (mesh, sharding rules, the meta-device
trees, the dry-run, the roofline and the report).

The reference's specs are ``jax.sharding.PartitionSpec``s, which write a
1-tuple of axes as its one name; the port's are plain tuples written the same
way, so ``tuple(P)`` compares one for one.  The reference meshes are
abstract (one CPU device repeated), as its own tests build them: only their
axis sizes are read.  Importing the reference's ``launch/dryrun.py`` sets a
512-device ``XLA_FLAGS`` at import; it is imported only inside a test, after
``jax.devices()`` has initialized the backend, as its own test does.
"""
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_serving import one_torch_thread  # noqa: F401
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
from repro.launch import report as jreport
from repro.launch import roofline as jrl
from repro.models import model_zoo as jzoo
from repro.serving.engine import freeze_params as jfreeze
from repro.train import sharding as jsharding
import repro_torch.configs as configs
from repro_torch.device import resolve_device
from repro_torch.kernels import tally, tsar_lut, tsar_matmul, tsar_sparse
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.optim import OptConfig
from repro_torch.serving import freeze_params
from repro_torch.train import init_state, sharding

ARCHS = sorted(configs.ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(dims, axes):
    devs = np.array(jax.devices() * int(np.prod(dims)))[:int(np.prod(dims))]
    return JMesh(devs.reshape(dims), axes)


def _jspecs(tree):
    """A reference spec tree as nested dicts of tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _shapes(tree, torch_side: bool):
    if isinstance(tree, dict):
        return {k: _shapes(v, torch_side) for k, v in tree.items()}
    dtype = str(tree.dtype).removeprefix("torch.") if torch_side else str(tree.dtype)
    return tuple(tree.shape), dtype


@pytest.fixture(scope="module")
def trees():
    """arch -> (latent, frozen) trees of both packages at full width: the
    reference's by ``eval_shape``, the port's on the meta device."""
    out = {}
    for arch in ARCHS:
        jlatent = jzoo.param_specs(jconfigs.get(arch))
        latent = model_zoo.param_specs(configs.get(arch))
        out[arch] = ((jlatent, latent),
                     (jax.eval_shape(jfreeze, jlatent), freeze_params(latent)))
    return out


# ---------------------------------------------------------------------------
# Mesh and sharding rules
# ---------------------------------------------------------------------------

def test_production_mesh_is_a_description():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model") and single.dims == (16, 16)
    assert single.shape["model"] == 16 and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert make_mesh((1, 1), ("data", "model")).size == 1
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data",))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(trees, arch, fsdp):
    """Latent and frozen trees at full width: the raw specs, then sanitized
    on the 16 x 16 and 2 x 16 x 16 meshes, equal the reference's."""
    for jtree, tree in trees[arch]:
        assert _shapes(tree, True) == _shapes(jtree, False)
        assert sharding.param_specs(tree, fsdp=fsdp) == _jspecs(
            jsharding.param_specs(jtree, fsdp=fsdp))
        for dims, axes in MESHES.values():
            got = sharding.param_specs(tree, make_mesh(dims, axes), fsdp=fsdp)
            want = jsharding.param_specs(jtree, _jmesh(dims, axes), fsdp=fsdp)
            assert got == _jspecs(want), (dims, fsdp)


def test_spec_rules():
    """The reference test's rule cases (``TestParamSpecs.test_rules``)."""
    specs = sharding.param_specs(model_zoo.param_specs(configs.get("deepseek-moe-16b")))
    assert specs["blocks"]["attn"]["wq"]["w"][-1] == "model"
    assert specs["blocks"]["attn"]["wo"]["w"][-2] == "model"
    assert specs["blocks"]["moe"]["w_gate"]["w"][-3] == "model"
    assert all(s is None for s in specs["blocks"]["moe"]["router"]["wd"])
    assert specs["embed"][0] == "model"


def test_sanitize_and_fsdp_placeholder():
    m, jm = make_mesh(*MESHES["16x16"]), _jmesh(*MESHES["16x16"])
    for shape, spec in (((51865, 384), ("model", None)), ((53248, 384), ("model", None)),
                        ((64, 128, 256), (None, "__data__", "model")),
                        ((64, 100, 256), (None, "__data__", "model"))):
        got = sharding.sanitize_spec(m, shape, spec)
        assert got == tuple(jsharding.sanitize_spec(jm, shape, P(*spec)))
    assert sharding.sanitize_spec(m, (51865, 384), ("model", None)) == (None, None)
    assert sharding.sanitize_spec(m, (64, 128, 256), (None, "__data__", "model")) == (
        None, "data", "model")
    mm = make_mesh(*MESHES["2x16x16"])
    assert sharding.sanitize_spec(mm, (64, 128, 256), (None, "__data__", "model")) == (
        None, ("pod", "data"), "model")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_and_batch_specs(mesh):
    """The reference test's cache cases (batch on data and heads on model;
    Hkv < |model| falls back to the sequence axis; batch 1 goes sequence-
    parallel), on both production meshes, and the batch rules."""
    m, jm = make_mesh(*MESHES[mesh]), _jmesh(*MESHES[mesh])
    for shape, hk in (((32, 128, 4096, 16, 128), 16), ((32, 128, 4096, 4, 256), 4),
                      ((32, 1, 524288, 4, 256), 4), ((48, 128, 3, 3328), 1),
                      ((48, 128, 48, 64, 128), 1), ((4, 3, 100, 5, 7), 5)):
        assert sharding.cache_spec(m, shape, hk) == tuple(jsharding.cache_spec(jm, shape, hk))
    s = sharding.cache_spec(make_mesh(*MESHES["16x16"]), (32, 128, 4096, 4, 256), 4)
    assert s[3] is None and s[2] == "model"
    batch = {"tokens": torch.empty((256, 4096), device="meta"),
             "t": torch.empty((), device="meta"),
             "odd": torch.empty((3, 5, 7), device="meta")}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32) for k, v in batch.items()}
    assert sharding.batch_specs(m, batch) == _jspecs(jsharding.batch_specs(jm, jbatch))


# ---------------------------------------------------------------------------
# The meta device
# ---------------------------------------------------------------------------

def test_meta_device_trees():
    """``resolve_device`` takes ``meta`` when named; params, caches, the
    train state and frozen trees build there (no generator); ``sparse=True``
    still emits pools there, shaped as on the CPU, ``"auto"`` emits none."""
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        resolve_device("xla")
    cfg = configs.get("bitnet-2b-4t").reduced()
    state = init_state(cfg, None, OptConfig(), device="meta")
    assert state.step.device.type == "meta" and state.opt.mu["embed"].is_meta
    assert model_zoo.init_cache(cfg, 2, 8, device="meta")["k"].is_meta
    latent = model_zoo.param_specs(cfg)
    cpu = model_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for sparse in (True, False):
        got = freeze_params(latent, sparse=sparse, block_shape=(64, 64))
        want = freeze_params(cpu, sparse=sparse, block_shape=(64, 64))
        assert _shapes(got, True) == _shapes(want, True)
    assert "sp_sign" in freeze_params(latent, sparse=True)["blocks"]["attn"]["wq"]
    assert "sp_sign" not in freeze_params(latent)["blocks"]["attn"]["wq"]


@pytest.mark.parametrize("cell", [f"{c.name}|{s.name}" for c, s, _ in
                                  jconfigs.cells(include_skipped=True)])
def test_input_specs_equal_reference(cell):
    arch, shape = cell.split("|")
    want = jzoo.input_specs(jconfigs.get(arch), jconfigs.SHAPES[shape])
    got = model_zoo.input_specs(configs.get(arch), configs.SHAPES[shape])
    assert _shapes(got, True) == _shapes(want, False)
    assert all(t.is_meta for t in jax.tree.leaves(got))


def _matmul_args(n, k, m):
    g = torch.Generator().manual_seed(0)
    a_q = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    planes = torch.randint(0, 256, (2, k // 8, m), generator=g, dtype=torch.uint8)
    return (a_q, torch.rand((n, 1), generator=g), planes[0], planes[1],
            torch.rand((m,), generator=g))


def test_kernel_meta_branches(monkeypatch):
    """On meta tensors each wrapper checks, pads, returns an empty output of
    the kernel's shape and dtype and tallies the call; it computes no plain
    version (patched to raise) and counts no launch."""
    for mod, name in ((tsar_matmul, "tsar_matmul_plain"),
                      (tsar_sparse, "tsar_sparse_padded_plain"), (tsar_lut, "tsar_lut_plain")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail("plain version ran"))
    launches = [dict(m.LAUNCHES) for m in (tsar_matmul, tsar_sparse, tsar_lut)]
    del tally.TALLY[:]
    args = [t.to("meta") for t in _matmul_args(5, 200, 132)]       # padded to 208 x 144
    out = tsar_matmul.tsar_matmul_packed(*args)
    assert out.is_meta and tuple(out.shape) == (5, 132) and out.dtype == torch.float32
    with pytest.raises(ValueError):
        tsar_matmul.tsar_matmul_packed(args[0][:, :8], *args[1:])
    f = lambda *s, d=torch.uint8: torch.empty(s, dtype=d, device="meta")  # noqa: E731
    out = tsar_sparse.tsar_sparse_padded_matmul_packed(
        f(3, 128, d=torch.int8), f(3, 1, d=torch.float32), f(6, 8, 36), f(6, 8, 36),
        f(2, 4, d=torch.int32), f(2, 4, d=torch.int32), f(2, d=torch.int32),
        f(72, d=torch.float32))
    assert tuple(out.shape) == (3, 72)
    out = tsar_sparse.tsar_sparse_matmul_packed(
        f(3, 128, d=torch.int8), f(3, 1, d=torch.float32), f(3, 8, 48), f(3, 8, 48),
        f(1, 2, d=torch.int32), f(1, 2, d=torch.int32), f(1, d=torch.int32),
        f(48, d=torch.float32))
    assert tuple(out.shape) == (3, 48)
    out = tsar_lut.tsar_lut_gemv(f(4, 64, d=torch.float32), f(16, 40), f(16, 40),
                                 f(40, d=torch.float32))
    assert tuple(out.shape) == (4, 40)
    # Bytes: every operand as the kernel is handed it (padded) and the
    # output, e.g. tsar_matmul's int8 a_q N*Kp, f32 a_scale 4N, two planes
    # Kp/8*Mp each, f32 w_scale 4Mp, f32 output 4*N*Mp.
    assert tally.TALLY == [
        tally.KernelCall("tsar_matmul", 5, 208, 144, 2 * 5 * 208 * 144,
                         5 * 208 + 4 * 5 + 2 * 26 * 144 + 4 * 144 + 4 * 5 * 144),
        tally.KernelCall("tsar_sparse_padded", 3, 128, 96, 2 * 3 * 128 * 96,
                         3 * 128 + 4 * 3 + 2 * 6 * 8 * 48 + 2 * 4 * 2 * 4 + 4 * 2 + 4 * 96
                         + 4 * 3 * 96),
        tally.KernelCall("tsar_sparse", 3, 128, 48, 2 * 3 * 128 * 48,
                         3 * 128 + 4 * 3 + 2 * 3 * 8 * 48 + 2 * 4 * 1 * 2 + 4 * 1 + 4 * 48
                         + 4 * 3 * 48),
        tally.KernelCall("tsar_lut", 4, 64, 48, 2 * 4 * 64 * 48,
                         4 * 4 * 64 + 2 * 16 * 48 + 4 * 48 + 4 * 4 * 40)]
    assert tally.nbytes() == sum(c.nbytes for c in tally.TALLY)
    assert tally.counts() == {"tsar_matmul": 1, "tsar_sparse_padded": 1, "tsar_sparse": 1,
                              "tsar_lut": 1}
    assert tally.ops() == sum(c.ops for c in tally.TALLY)
    assert [dict(m.LAUNCHES) for m in (tsar_matmul, tsar_sparse, tsar_lut)] == launches
    del tally.TALLY[:]


def test_kernel_cpu_branch_unchanged():
    """A CPU tensor still takes the plain version and tallies nothing."""
    del tally.TALLY[:]
    args = _matmul_args(3, 64, 32)
    assert torch.equal(tsar_matmul.tsar_matmul_packed(*args),
                       tsar_matmul.tsar_matmul_plain(*args))
    assert tally.TALLY == []


def test_meta_trace_follows_storages():
    """Outputs count once per storage; views and in-place results add
    nothing; freed temporaries leave the live count; arguments are excluded."""
    x = torch.empty((1024,), device="meta")
    mode = dryrun.MetaTrace({x.untyped_storage()._cdata})
    with mode:
        y = x * 2                 # 4 KiB
        z = y.view(32, 32)        # view: no bytes
        z.add_(1)                 # in place: no bytes
        w = (y + 1) * 3           # a 4 KiB temporary, then 4 KiB more
        del y, z
        x.mul_(2)
    assert mode.peak == 3 * 4096
    assert mode.live == 4096 and tuple(w.shape) == (1024,)


@pytest.mark.parametrize("cell", ["mamba2-780m|train", "hymba-1.5b|decode",
                                  "deepseek-moe-16b|prefill", "whisper-tiny|train"])
def test_meta_trace_flops_equal_flop_counter(one_torch_thread, cell):  # noqa: F811
    """``MetaTrace`` counts the FLOPs ``FlopCounterMode`` counts (same
    formulas, no decomposition pass), forward and backward, on reduced
    cells of four families."""
    from torch.utils.flop_counter import FlopCounterMode

    arch, kind = cell.split("|")
    shape = configs.ShapeConfig("s", 32, 2, kind)
    lowered, _ = dryrun.lower_cell(configs.get(arch).reduced(), shape,
                                   make_mesh((1, 1), ("data", "model")))
    trace = dryrun.MetaTrace(set())
    with FlopCounterMode(display=False) as fc, trace:
        lowered.run()
    del tally.TALLY[:]
    assert trace.flops == fc.get_total_flops() > 0


# ---------------------------------------------------------------------------
# Roofline and report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", [f"{c.name}|{s.name}" for c, s, _ in
                                  jconfigs.cells(include_skipped=True)])
def test_model_flops_equal_reference(cell):
    arch, shape = cell.split("|")
    assert roofline.model_flops_for_cell(configs.get(arch), configs.SHAPES[shape]) == \
        jrl.model_flops_for_cell(jconfigs.get(arch), jconfigs.SHAPES[shape])


@dataclasses.dataclass
class _MemStats:
    argument_size_in_bytes: float
    output_size_in_bytes: float
    temp_size_in_bytes: float


def _hlo(collectives: dict) -> str:
    """A partitioned HLO module holding one f32 collective of each kind's
    bytes, for the reference's ``hlo_program_costs``."""
    lines = [f"  %c{i} = f32[{int(b) // 4}]{{0}} {kind}(%p), replica_groups={{}}"
             for i, (kind, b) in enumerate(collectives.items())]
    return "\n".join(["ENTRY %main (p: f32[4]) -> f32[4] {", "  %p = f32[4]{0} parameter(0)",
                      *lines, "  ROOT %r = f32[4]{0} copy(%p)", "}"])


def _assert_analyze_equal(chips, flops, args, outs, collectives, accessed=0.0):
    """The reference's ``analyze`` on its per-device cost (``accessed``
    bytes accessed where given) and a partitioned module with
    ``collectives``, against the port's on the same per-device counts (its
    kernel ops split off) and collective bytes: equal FLOPs,
    bytes, collectives by kind, useful ratio and peak; each term the
    reference's times the ratio of the two packages' constants (TPU v5e
    there, H100 here: ``ICI_LINK_BW / NVLINK_BW`` for the collective term);
    the bound the largest of the port's own terms."""
    mem = _MemStats(args, outs, 3e9)
    cost = {"flops": flops, **({"bytes accessed": accessed} if accessed else {})}
    want = jrl.analyze("a", "s", "single", chips, cost, _hlo(collectives), 6e14,
                       memory_stats=mem)
    counts = {"flops": 0.75 * flops, "kernel_ops": 0.25 * flops,
              **({"bytes accessed": accessed} if accessed else {})}
    got = roofline.analyze("a", "s", "single", chips, counts, 6e14,
                           memory_stats=dataclasses.asdict(mem), collectives=collectives)
    for key in ("flops_per_device", "bytes_per_device", "useful_flops_ratio",
                "peak_memory_bytes", "model_flops", "collective_bytes_per_device",
                "collectives"):
        assert getattr(got, key) == pytest.approx(getattr(want, key), rel=1e-12), key
    for term, ratio in (("compute_s", jrl.PEAK_FLOPS_BF16 / roofline.PEAK_FLOPS_BF16),
                        ("memory_s", jrl.HBM_BW / roofline.HBM_BW),
                        ("collective_s", jrl.ICI_LINK_BW / roofline.NVLINK_BW)):
        assert getattr(got, term) == pytest.approx(getattr(want, term) * ratio, rel=1e-12), term
    assert got.compute_s == pytest.approx(got.flops_per_device / roofline.PEAK_FLOPS_BF16)
    assert got.memory_s == pytest.approx(max(accessed, args + outs) / roofline.HBM_BW)
    terms = {"compute": got.compute_s, "memory": got.memory_s, "collective": got.collective_s}
    assert got.bound == max(terms, key=terms.get) and got.note == ""
    assert "| a " in roofline.format_table([got.to_json()])
    return got


@pytest.mark.parametrize("chips", [1, 256])
@pytest.mark.parametrize("flops,args,outs,accessed", [
    pytest.param(1e12, 1e9, 1e8, 0.0, id="1000000000000.0-1000000000.0-100000000.0"),
    pytest.param(1e9, 5e10, 1e9, 0.0, id="1000000000.0-50000000000.0-1000000000.0"),
    pytest.param(3e14, 2e11, 7e10, 0.0, id="300000000000000.0-200000000000.0-70000000000.0"),
    pytest.param(0.0, 1e6, 0.0, 0.0, id="0.0-1000000.0-0.0"),
    # Bytes accessed above argument + output bytes: they set the memory term.
    pytest.param(1e12, 1e9, 1e8, 4e12, id="accessed-memory-bound"),
    pytest.param(3e14, 2e10, 7e9, 9e10, id="accessed-compute-bound"),
    # Below them: the floor holds.
    pytest.param(1e9, 5e10, 1e9, 2e10, id="accessed-below-floor"),
])
def test_analyze_equal_reference(chips, flops, args, outs, accessed):
    """Same per-device counts, no collectives: the reference's terms, bound
    and ratios, and a collective term of 0; the memory term and
    ``bytes_per_device`` are ``max(bytes accessed, argument + output
    bytes)``, the reference's on ``cost={"bytes accessed": ...}``."""
    got = _assert_analyze_equal(chips, flops, args, outs, {}, accessed)
    assert got.collective_s == 0.0 and got.collectives == {}
    assert got.bytes_per_device == max(accessed, args + outs)


@pytest.mark.parametrize("chips", [4, 256])
@pytest.mark.parametrize("flops,args,outs,collectives", [
    (1e12, 1e9, 1e8, {"all-gather": 4e10}),
    (1e9, 5e8, 1e6, {"all-reduce": 8e8, "reduce-scatter": 2e8}),
    (3e14, 2e10, 7e9, {"all-gather": 6e11, "all-reduce": 1e9, "all-to-all": 4e9}),
])
def test_analyze_collective_bound_equal_reference(chips, flops, args, outs, collectives):
    """Cells whose collectives bound the step: the port's bytes by kind are
    the reference's from the partitioned module, and the bound is
    ``collective``."""
    got = _assert_analyze_equal(chips, flops, args, outs, collectives)
    assert got.bound == "collective" and got.collective_bytes_per_device == sum(
        collectives.values())


def _records():
    """A record list in the dry-run schema: ok and failed cells, both
    meshes, both weight formats, a re-run of one cell."""
    recs = []
    rng = np.random.default_rng(0)
    for i, (arch, shape) in enumerate([("gemma2-2b", "decode_32k"), ("qwen3-32b", "prefill_32k"),
                                       ("bitnet-2b-4t", "long_500k"), ("hymba-1.5b", "train_4k")]):
        for mesh, chips in (("single", 256), ("multi", 512)):
            for weights in ("packed", "dense"):
                f, b, c = (10.0 ** rng.uniform(6, 15) for _ in range(3))
                roof = {"flops_per_device": f, "bytes_per_device": b,
                        "collective_bytes_per_device": c, "compute_s": f / 1e15,
                        "memory_s": b / 3e12, "collective_s": c / 4e11,
                        "useful_flops_ratio": rng.uniform(0, 200), "bound": "memory"}
                recs.append({"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
                             "weights": weights, "status": "ok", "mode": "serve_step",
                             "roofline": roof,
                             "memory_analysis": {"argument_size_in_bytes": b / 7,
                                                 "temp_size_in_bytes": 10.0 ** (3 + i)}})
    recs.append(dict(recs[0], status="error"))
    recs.append(dict(recs[1], memory_analysis={}))
    return recs


def test_report_tables_equal_reference():
    recs = json.loads(json.dumps(_records()))
    for mesh in ("single", "multi"):
        assert report.dryrun_table(recs, mesh) == jreport.dryrun_table(recs, mesh)
        assert report.roofline_table(recs, mesh) == jreport.roofline_table(recs, mesh)
    packed = [r for r in recs if r["weights"] == "packed"]
    dense = [r for r in recs if r["weights"] == "dense"]
    assert report.compare_weights(packed, dense) == jreport.compare_weights(packed, dense)
    assert report.dedup(recs) == jreport.dedup(recs)


# ---------------------------------------------------------------------------
# The dry-run on reduced cells, against XLA's argument sizes
# ---------------------------------------------------------------------------

REDUCED_CELLS = {
    # name: (arch, shape, weights)
    "gemma2_train": ("gemma2-2b", ("t", 64, 4, "train"), "packed"),
    "gemma2_decode": ("gemma2-2b", ("d", 64, 4, "decode"), "packed"),
    "bitnet_decode": ("bitnet-2b-4t", ("d", 64, 4, "decode"), "packed"),
    "bitnet_decode_dense": ("bitnet-2b-4t", ("d", 64, 4, "decode"), "dense"),
}


def _density_leaves(tree, path=()):
    """(path, bytes) of every frozen ``density`` leaf."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _density_leaves(v, path + (k,))]
    return [("/".join(path), tree.numel() * tree.element_size())] if path[-1] == "density" else []


@pytest.mark.parametrize("name", sorted(REDUCED_CELLS))
def test_reduced_dry_run_against_xla(one_torch_thread, name):  # noqa: F811
    """``run_cell`` on a 1 x 1 mesh returns ok, with the reference's record
    keys; its argument bytes equal XLA's ``argument_size_in_bytes`` for the
    same cell, but for the leaves XLA prunes: a decode step never reads the
    frozen ``density`` scalars, and ``jax.jit`` drops unused arguments
    (``keep_unused=False``), so they are exactly the difference."""
    jax.devices()
    from repro.launch.dryrun import lower_cell as jlower_cell   # sets XLA_FLAGS at import

    arch, shape, weights = REDUCED_CELLS[name]
    cfg = configs.get(arch).reduced()
    rec = dryrun.run_cell(cfg, configs.ShapeConfig(*shape), make_mesh((1, 1), ("data", "model")),
                          "1x1", weights=weights, verbose=False, fsdp=False)
    assert rec["status"] == "ok", rec.get("error")
    assert {"arch", "shape", "mesh", "chips", "weights", "status", "mode", "roofline", "cost",
            "memory_analysis", "wall_s"} <= set(rec)
    mem = rec["memory_analysis"]
    assert mem["temp_size_in_bytes"] > 0 and rec["roofline"]["flops_per_device"] > 0
    lowered, _ = jlower_cell(jconfigs.get(arch).reduced(), jconfigs.ShapeConfig(*shape),
                             jax.make_mesh((1, 1), ("data", "model")), fsdp=False,
                             weights=weights)
    xla = lowered.compile().memory_analysis().argument_size_in_bytes
    pruned = []
    if shape[3] == "decode" and weights == "packed":
        params = freeze_params(model_zoo.param_specs(cfg))
        pruned = _density_leaves(params)
        assert sorted(p for p, _ in pruned) == [f"blocks/{blk}/{w}/density" for blk, ws in
                                          (("attn", ("wk", "wo", "wq", "wv")),
                                           ("mlp", ("w_down", "w_gate", "w_up")))
                                          for w in ws]
    assert mem["argument_size_in_bytes"] - sum(b for _, b in pruned) == xla
    if shape[3] == "decode":
        assert rec["kernels"] == ({"tsar_matmul": 7 * cfg.n_layers} if weights == "packed"
                                  else {})


def test_packed_arguments_below_dense(one_torch_thread):  # noqa: F811
    """The T-SAR serve path moves fewer weight bytes than dense bf16
    (the reference's ``test_packed_weights_shrink_arguments``)."""
    cfg = configs.get("bitnet-2b-4t").reduced()
    shape = configs.ShapeConfig("d", 64, 4, "decode")
    mesh = make_mesh((1, 1), ("data", "model"))
    size = {w: dryrun.run_cell(cfg, shape, mesh, "1x1", weights=w, verbose=False)
            ["memory_analysis"]["argument_size_in_bytes"] for w in ("packed", "dense")}
    assert size["packed"] < size["dense"]


def test_cli_writes_records_either_report_reads(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.dryrun`` on a full-width cell and both
    meshes writes the reference's record schema; ``--skip-done`` skips what
    is there; both packages' ``report.main`` read the file alike."""
    out = tmp_path / "dr.json"
    args = ["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "both",
            "--out", str(out)]
    assert dryrun.main(args) == 0
    recs = json.loads(out.read_text())
    assert [(r["mesh"], r["chips"], r["status"], r["mode"]) for r in recs] == [
        ("single", 256, "ok", "serve_step"), ("multi", 512, "ok", "serve_step")]
    assert recs[0]["kernels"] == {"tsar_matmul": 32}
    assert dryrun.main(args + ["--skip-done"]) == 0
    assert len(json.loads(out.read_text())) == 2
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["report", str(out)])
    report.main()
    jreport.main()
    port_text, ref_text = capsys.readouterr().out.split("## Dry-run (single-pod)")[1:]
    assert "## Dry-run (single-pod)" + port_text == "## Dry-run (single-pod)" + ref_text
    assert "| whisper-tiny | decode_32k | serve_step | 256 |" in port_text
