"""Port vs reference: the kernel registry, the cost models, ``compile_plan``,
the plan JSON and the serve-time runtime.

The port's cost models read H100 constants; with the reference's TPU
constants patched in, every kernel's cost must equal the reference's to the
last bit, which shows the formulas were carried over unchanged.  Plans
compiled by the two packages on the same frozen reduced ``bitnet-2b-4t``
name the same kernel per (layer, bucket) (estimated times differ by
design), and a plan's JSON written by either package loads in the other and
comes back byte-equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core import dataflow as jdataflow
from repro.core import hw as jhw
from repro.core import ternary as jternary
from repro.models import model_zoo as jzoo
from repro.plan import ModelPlan as JModelPlan
from repro.plan import compile_plan as jcompile_plan
from repro.plan import format_plan as jformat_plan
from repro.plan import registry as jregistry
from repro.serving.engine import freeze_params as jfreeze
from repro_torch import bridge
from repro_torch.core import dataflow, hw
from repro_torch.plan import (PLAN_VERSION, BatchProfile, LayerPlan, ModelPlan,
                              compile_plan, format_plan, registry, runtime)

PROFILE = dict(decode_ns=(1, 2), prefill_ns=(8, 18, 10))
SHAPES = [(1, 2560, 2560), (4, 2560, 640), (20, 2560, 6912), (20, 6912, 2560),
          (16, 128, 256)]


@pytest.fixture(scope="module")
def frozen_dense():
    cfg = jconfigs.get("bitnet-2b-4t").reduced()
    frozen = jfreeze(jzoo.init_params(cfg, jax.random.PRNGKey(0)))
    return frozen, bridge.params_from_reference(jax.tree.map(np.asarray, frozen),
                                                device="cpu")


@pytest.fixture
def tpu_constants(monkeypatch):
    """The port's hw module with the reference's constants patched in."""
    for name in ("PEAK_FLOPS_BF16", "PEAK_FLOPS_INT8", "HBM_BW"):
        monkeypatch.setattr(hw, name, getattr(jhw, name))


def test_registry_names_and_flags_match_reference():
    assert registry.names() == jregistry.names()
    assert len(registry.names()) == 6
    assert registry.selectable_names() == jregistry.selectable_names()
    assert registry.SPARSE_KERNELS == jregistry.SPARSE_KERNELS
    assert registry.SPARSE_BLOCK == jregistry.SPARSE_BLOCK
    assert registry.DEFAULT_DENSITY == jregistry.DEFAULT_DENSITY
    for name in registry.names():
        mine, theirs = registry.get(name), jregistry.get(name)
        assert isinstance(mine, registry.KernelImpl)
        assert (mine.selectable, mine.serve_via_registry) == \
            (theirs.selectable, theirs.serve_via_registry), name
    with pytest.raises(ValueError, match="unknown kernel"):
        registry.get("nope")


@pytest.mark.parametrize("name", jregistry.names())
def test_cost_formulas_equal_reference_under_its_constants(name, tpu_constants):
    for n, k, m in SHAPES:
        for bd in (None, 0.25, 0.5, 1.0):
            kw = {"block_density": bd, "block_shape": (64, 64)}
            assert registry.get(name).cost(n, k, m, **kw) == \
                jregistry.get(name).cost(n, k, m, **kw), (name, n, k, m, bd)


def test_h100_constants():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_INT8, hw.HBM_BW) == (989e12, 1979e12, 3.35e12)
    assert hw.SMEM_BYTES == 228 * 1024
    assert (hw.SPARSE_ISSUE_TAX, hw.SPARSE_PAD_STEP_FRAC) == \
        (jhw.SPARSE_ISSUE_TAX, jhw.SPARSE_PAD_STEP_FRAC)


def test_calibration_api(tmp_path):
    try:
        hw.set_calibration(sparse_issue_tax=1.5)
        assert hw.sparse_issue_tax() == 1.5
        assert hw.calibration()["sparse_pad_step_frac"] == hw.SPARSE_PAD_STEP_FRAC
        with pytest.raises(ValueError):
            hw.set_calibration(bogus=1.0)
        with pytest.raises(ValueError):
            hw.set_calibration(sparse_issue_tax=0.0)
        path = tmp_path / "cal.json"
        hw.save_calibration(path)
        hw.clear_calibration()
        assert hw.sparse_issue_tax() == hw.SPARSE_ISSUE_TAX
        assert hw.load_calibration(path) == {"sparse_issue_tax": 1.5}
        assert hw.sparse_issue_tax() == 1.5
    finally:
        hw.clear_calibration()


def test_select_kernel_and_break_even_match_reference_under_its_constants(tpu_constants):
    for n, k, m in SHAPES:
        for bd in (0.3, 0.6, 0.95):
            for ok in (None, ("tsar_sparse_padded",), ()):
                mine = dataflow.select_kernel(n, k, m, block_density=bd,
                                              block_shape=(64, 64), sparse_ok=ok)
                theirs = jdataflow.select_kernel(n, k, m, block_density=bd,
                                                 block_shape=(64, 64), sparse_ok=ok)
                assert (mine.kernel, mine.est_time_s, mine.bound) == \
                    (theirs.kernel, theirs.est_time_s, theirs.bound)
        for kern in registry.SPARSE_KERNELS:
            assert dataflow.sparse_break_even(n, k, m, kernel=kern) == \
                jdataflow.sparse_break_even(n, k, m, kernel=kern)
    with pytest.raises(ValueError):
        dataflow.sparse_break_even(1, 128, 128, kernel="tsar_mxu")


@pytest.mark.parametrize("n,k,m", [(1, 128, 256), (8, 2560, 2560), (64, 6912, 2560)])
def test_select_dataflow_against_shared_memory(n, k, m):
    got = dataflow.select_dataflow(n, k, m)
    assert got in ("AP", "OP")
    # The same heuristic as the reference, with the SM's shared memory as
    # the budget in place of VMEM.
    assert got == jdataflow.select_dataflow(n, k, m, vmem_budget=hw.SMEM_BYTES)


def test_compile_plan_matches_reference_kernels_on_dense_model(frozen_dense):
    jfrozen, params = frozen_dense
    mine = compile_plan(params, BatchProfile(**PROFILE))
    theirs = jcompile_plan(jfrozen, _jprofile())
    assert mine.buckets == theirs.buckets
    assert dict(mine.shapes) == dict(theirs.shapes)
    assert set(mine.layers) == set(theirs.layers)
    for name, by_n in theirs.layers.items():
        for n, lp in by_n.items():
            assert mine.layers[name][n].kernel == lp.kernel, (name, n)
            assert mine.layers[name][n].density == pytest.approx(lp.density, rel=1e-6)
    assert mine.kernel_counts(1) == theirs.kernel_counts(1)
    assert mine.summary()["decode_kernel"] == theirs.summary()["decode_kernel"]
    assert mine.coverage(params) == (7, 7)


def _jprofile():
    from repro.plan import BatchProfile as JBatchProfile

    return JBatchProfile(**PROFILE)


def test_plan_json_round_trips_both_ways(frozen_dense):
    jfrozen, params = frozen_dense
    theirs = jcompile_plan(jfrozen, _jprofile())
    mine = ModelPlan.from_json(theirs.to_json())
    assert mine.to_json() == theirs.to_json()
    assert mine.version == PLAN_VERSION == theirs.version
    ours = compile_plan(params, BatchProfile(**PROFILE))
    back = JModelPlan.from_json(ours.to_json())
    assert back.to_json() == ours.to_json()
    assert ModelPlan.from_json(back.to_json(indent=None)).to_json() == ours.to_json()
    assert format_plan(mine) == jformat_plan(theirs)


def test_plan_version_mismatch_raises(tmp_path, frozen_dense):
    _, params = frozen_dense
    plan = compile_plan(params, BatchProfile(**PROFILE))
    path = tmp_path / "plan.json"
    plan.save(path)
    assert ModelPlan.load(path) == plan
    payload = json.loads(plan.to_json())
    payload["version"] = PLAN_VERSION + 1
    with pytest.raises(ValueError, match="plan version"):
        ModelPlan.from_json(json.dumps(payload))
    with pytest.raises(ValueError, match="plan version"):
        JModelPlan.from_json(json.dumps(payload))


def _toy_plan(kernels):
    lp = {n: LayerPlan(kern, "AP", (), 1e-6, "memory", 0.66)
          for n, kern in zip((1, 4, 20), kernels)}
    return {"a": lp, "b": dict(lp)}


def _as(lp):
    return None if lp is None else dataclasses.asdict(lp)


@pytest.mark.parametrize("conflict", [False, True])
def test_lookup_and_shape_conflicts_match_reference(conflict):
    layers = _toy_plan(["tsar_mxu", "tsar_lut", "dense"])
    if conflict:
        layers["b"] = {n: dataclasses.replace(lp, kernel="memory_lut")
                       for n, lp in layers["b"].items()}
    shapes = {"a": (128, 256, 4), "b": (128, 256, 4)}
    mine = ModelPlan(buckets=(1, 4, 20), shapes=shapes, layers=layers)
    theirs = JModelPlan.from_json(mine.to_json())
    assert mine.shape_conflicts() == theirs.shape_conflicts()
    for n in (1, 3, 4, 5, 20, 99):
        assert mine.bucket_for(n) == theirs.bucket_for(n)
        assert _as(mine.lookup_shape(121, 256, n)) == _as(theirs.lookup_shape(121, 256, n))
        assert _as(mine.lookup("a", n)) == _as(theirs.lookup("a", n))
        assert mine.dominant_kernel(n) == theirs.dominant_kernel(n)


def test_runtime_activate_is_reentrant_and_none_is_noop():
    plan = ModelPlan(buckets=(1, 4), shapes={"a": (128, 256, 4)},
                     layers={"a": {n: lp for n, lp in _toy_plan(["tsar_mxu"] * 3)["a"].items()
                                   if n in (1, 4)}})
    assert runtime.current() is None and runtime.planned(128, 256, 1) is None
    with runtime.activate(plan):
        assert runtime.planned(128, 256, 3).kernel == "tsar_mxu"
        with runtime.activate(None):
            assert runtime.current() is plan
        other = ModelPlan(buckets=(1,), shapes={}, layers={})
        with runtime.activate(other):
            assert runtime.planned(128, 256, 1) is None
        assert runtime.current() is plan
    assert runtime.current() is None


def _layer(seed=0, k=200, m=96):
    rng = np.random.default_rng(seed)
    t = rng.integers(-1, 2, size=(k, m)).astype(np.int8)
    scale = (rng.random(m) + 0.05).astype(np.float32)
    x = rng.standard_normal((5, k)).astype(np.float32)
    jtw = jternary.pack(jnp.asarray(t), jnp.asarray(scale))
    jdict = {"sign": jtw.sign_plane, "zero": jtw.zero_plane, "scale": jtw.scale}
    tdict = {key: torch.from_numpy(np.array(v)) for key, v in jdict.items()}
    return x, jdict, tdict


@pytest.mark.parametrize("name,exact", [("tsar_mxu", True), ("dense", False),
                                        ("memory_lut", False)])
def test_plain_lowerings_match_reference(name, exact):
    x, jdict, tdict = _layer()
    assert registry.get(name).supports(tdict)
    got = registry.get(name).lower(tdict, torch.from_numpy(x)).numpy()
    want = np.asarray(jregistry.get(name).lower(jdict, jnp.asarray(x)))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["tsar_lut", "tsar_sparse"])
def test_unported_lowerings_raise(name):
    # Both kernels are ported; a layer without their encodings (a packed
    # dict has no LUT indices and no compacted pool) still raises.
    x, _, tdict = _layer()
    assert not registry.get(name).supports(tdict)
    with pytest.raises(ValueError, match="frozen without"):
        registry.get(name).lower(tdict, torch.from_numpy(x))


def test_tiles_are_the_cuda_launch_picks():
    from repro_torch.core import hw
    from repro_torch.kernels import tsar_lut, tsar_matmul, tsar_sparse

    # (rows per CTA: whole 8-row n-tiles, k per ring stage, columns per CTA)
    # of the cluster kernel's launch_config on an H100's 132 SMs.
    assert registry.get("tsar_mxu").tiles(4, 2560, 2560) == (8, 224, 64)
    cfg = tsar_matmul.launch_config(20, 2560, 2560, hw.SM_COUNT)
    assert registry.get("tsar_mxu").tiles(20, 2560, 2560) == (8 * cfg.n_tiles,
                                                               32 * cfg.stage_steps, cfg.bm)
    assert registry.get("tsar_mxu").tiles(20, 2560, 2560) == (24, 224, 64)
    # (rows per CTA, k per ring stage, columns per CTA) of the sparse cluster
    # kernel's launch_config for (256, 256) blocks, every k-block live.
    cfg = tsar_sparse.launch_config(33, 256, 256, 10, 10, hw.SM_COUNT)
    assert registry.get("tsar_sparse_padded").tiles(33, 2560, 2560) == (
        8 * cfg.n_tiles, 256 * cfg.stage_blocks, cfg.bm)
    assert registry.get("tsar_sparse_padded").tiles(33, 2560, 2560) == (32, 1024, 64)
    assert registry.get("tsar_sparse").tiles(4, 2560, 2560) == (8, 512, 64)
    assert registry.get("tsar_sparse").tiles(20, 6912, 2560) == (24, 2304, 64)
    # (rows per CTA, c-blocks per ring stage, columns per CTA) of the
    # cluster kernel's launch_config.
    assert registry.get("tsar_lut").tiles(4, 2560, 2560) == (4, 20, 128)
    cfg = tsar_lut.launch_config(20, 1280, 2560, 2, hw.SM_COUNT)
    assert registry.get("tsar_lut").tiles(20, 2560, 2560, c=2) == (cfg.rows, cfg.stage_blocks,
                                                                   cfg.bm)
    assert registry.get("tsar_lut").tiles(20, 2560, 2560, c=2) == (7, 80, 128)
    assert registry.get("dense").tiles(4, 128, 128) == ()
