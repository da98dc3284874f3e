"""Port vs reference: the planned serving path on a block-sparse checkpoint.

The reduced ``bitnet-2b-4t`` has about half of every BitLinear's (64, 64)
weight blocks structurally dead (block (0, 0) always), as in the reference's
own acceptance test (``tests/test_plan.py::TestSparseServing``).  The
reference engine (``packed=True``, ``sparse_block=(64, 64)``) freezes it with
padded pools and plans ``tsar_sparse_padded`` for every layer; the port's
engine serves the same frozen tree (carried across with the bridge) on the
CPU.  The freeze's ``sp_*`` leaves, the plan's kernels, the ``FlatStepPlan``
sequence, the greedy tokens and the counters must be identical, and every
projection of every step must go through the port's sparse wrapper.
"""
import dataclasses
import warnings
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import engine as jengine
from repro.sparse import format as jformat
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.plan import LayerPlan, ModelPlan
from repro_torch.serving import Request, ServingEngine, engine, freeze_params

BK = 64
ENGINE_KW = dict(max_len=48, batch_slots=2, sparse_block=(BK, BK))
COUNTERS = ("steps", "prefill_tokens", "decode_tokens", "total_tokens",
            "peak_kv_blocks", "max_step_tokens", "preemptions", "plan_layers",
            "plan_shape_conflicts")
PLAN_FIELDS = ("tokens", "slot", "pos", "n_real", "emit", "emit_row", "width",
               "view_blocks", "prefill_tokens", "decode_tokens")
SP_LEAVES = ("sp_sign", "sp_zero", "sp_map", "sp_kids", "sp_slots", "sp_counts",
             "block_density")


def _requests(cls):
    return [cls(uid=i, prompt=(np.arange(4 + 3 * i) * 7 % 100).astype(np.int32),
                max_new_tokens=5) for i in range(3)]


def _record_plans(eng):
    plans = []
    inner = eng.sched.plan_flat

    def plan_flat(*args, **kw):
        plan = inner(*args, **kw)
        plans.append(plan)
        return plan

    eng.sched.plan_flat = plan_flat
    return plans


def _plan_key(plan):
    return tuple(np.asarray(getattr(plan, f)).tolist() for f in PLAN_FIELDS)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def sparse_ref():
    """The block-sparse latent checkpoint, and the reference engine's freeze,
    plan, step plans, tokens and stats over three requests."""
    cfg = jconfigs.get("bitnet-2b-4t").reduced()
    params = jzoo.init_params(cfg, jax.random.PRNGKey(0))

    def blockify(node, path=""):
        if isinstance(node, dict):
            if set(node) == {"w"}:
                w = node["w"]
                k, m = w.shape[-2:]
                mask = jnp.abs(jformat.random_block_sparse_ternary(
                    jax.random.PRNGKey(zlib.crc32(path.encode()) % 2**31), (k, m),
                    bk=BK, bm=BK, p_zero_block=0.5, p_zero=0.0).astype(jnp.float32))
                return {"w": w * mask.at[:BK, :BK].set(0.0)}
            return {k2: blockify(v, f"{path}/{k2}") for k2, v in node.items()}
        return node

    latent = blockify(params)
    ref = JServingEngine(cfg, latent, packed=True, **ENGINE_KW)
    plans = _record_plans(ref)
    reqs = ref.run(_requests(JRequest))
    return {"cfg": cfg, "latent": latent, "ref": ref, "plans": plans,
            "tokens": [r.out_tokens for r in reqs],
            "frozen": jax.tree.map(np.asarray, ref.params)}


def _port_params(sparse_ref):
    return bridge.params_from_reference(sparse_ref["frozen"], device="cpu")


def test_freeze_params_pools_byte_equal_to_reference(sparse_ref):
    mine = dict(_leaves(freeze_params(
        bridge.params_from_reference(jax.tree.map(np.asarray, sparse_ref["latent"]),
                                     device="cpu"),
        sparse="auto", block_shape=(BK, BK))))
    ref = dict(_leaves(sparse_ref["frozen"]))
    assert set(mine) == set(ref)
    pooled = {k.rsplit("/", 1)[0] for k in ref if k.endswith("/sp_sign")}
    assert len(pooled) == 7, "pools for all 7 projections"
    for name, arr in ref.items():
        got = mine[name].numpy()
        assert got.dtype == arr.dtype and got.shape == arr.shape, name
        if name.rsplit("/", 1)[1] in ("sign", "zero") + SP_LEAVES[:-1]:
            assert got.tobytes() == arr.tobytes(), name
        else:       # scale, density, block_density: float32 sums, a few ulps
            np.testing.assert_allclose(got, arr, rtol=1e-6, atol=0, err_msg=name)
    cfg = sparse_ref["cfg"]
    assert mine["/blocks/attn/wq/sp_sign"].shape[0] == cfg.n_layers


def test_freeze_params_sparse_modes(sparse_ref):
    latent = bridge.params_from_reference(jax.tree.map(np.asarray, sparse_ref["latent"]),
                                          device="cpu")
    planes = freeze_params(latent, sparse=False)
    assert not any("sp_" in k for k, _ in _leaves(planes))
    full = freeze_params(latent, sparse=True, block_shape=(BK, BK))
    wq = full["blocks"]["attn"]["wq"]
    assert wq["sp_sign"].shape[1] == (128 // BK) * (128 // BK)    # full grid
    assert wq["sp_kids"].shape[-1] == 128 // BK
    with pytest.raises(ValueError, match="max_live"):
        freeze_params(latent, sparse=True, block_shape=(BK, BK), max_live=1)
    with pytest.raises(ValueError, match="must be True, False"):
        freeze_params(latent, sparse="yes")
    # Dense absmean weights keep every block live: auto emits no pools.
    dense = freeze_params({"w_up": {"w": torch.randn(2, 128, 128,
                                                     generator=torch.Generator().manual_seed(0))}},
                          block_shape=(BK, BK))
    assert set(dense["w_up"]) == {"sign", "zero", "scale", "density"}


def test_pack_linear_matches_reference(sparse_ref):
    w = np.array(sparse_ref["latent"]["blocks"]["mlp"]["w_up"]["w"][0])
    want = jlayers.pack_linear({"w": jnp.asarray(w)}, sparse=True, block_shape=(BK, BK),
                               max_live=6, s_steps=2)
    got = layers.pack_linear({"w": torch.from_numpy(w)}, sparse=True, block_shape=(BK, BK),
                             max_live=6, s_steps=2)
    for key in SP_LEAVES[:-1] + ("sign", "zero"):
        assert got[key].numpy().tobytes() == np.asarray(want[key]).tobytes(), key
    assert float(got["block_density"]) == float(want["block_density"])
    plan = ModelPlan(buckets=(1,), shapes={"w": (128, 256, 4)}, layers={"w": {
        1: LayerPlan("dense", "AP", (), 0.0, "memory", 0.5)}})
    wd = layers.pack_linear({"w": torch.from_numpy(w)}, plan, name="w")
    assert set(wd) == {"wd"}
    jwd = jlayers.pack_linear({"w": jnp.asarray(w)}, "dense")
    np.testing.assert_allclose(wd["wd"].numpy(), np.asarray(jwd["wd"]), rtol=1e-6)


def test_engine_matches_reference_on_block_sparse_model(sparse_ref, monkeypatch):
    ref, cfg = sparse_ref["ref"], sparse_ref["cfg"]
    assert {lp.kernel for by_n in ref.plan.layers.values() for lp in by_n.values()} == \
        {"tsar_sparse_padded"}
    calls = {"tsar_sparse_padded": 0, "tsar_matmul": 0}
    for name, attr in (("tsar_sparse_padded", "tsar_sparse_padded_matmul"),
                       ("tsar_matmul", "tsar_matmul")):
        inner = getattr(ops, attr)

        def counted(*args, _inner=inner, _name=name, **kw):
            calls[_name] += 1
            return _inner(*args, **kw)

        monkeypatch.setattr(ops, attr, counted)

    port = ServingEngine(cfg, _port_params(sparse_ref), device="cpu", **ENGINE_KW)
    for name, by_n in ref.plan.layers.items():
        assert {n: lp.kernel for n, lp in port.plan.layers[name].items()} == \
            {n: lp.kernel for n, lp in by_n.items()}, name
    plans = _record_plans(port)
    reqs = port.run(_requests(Request))
    assert [_plan_key(p) for p in plans] == [_plan_key(p) for p in sparse_ref["plans"]]
    assert [r.out_tokens for r in reqs] == sparse_ref["tokens"]
    for key in COUNTERS:
        assert port.stats[key] == ref.stats[key], key
    for key in ("weight_density_mean", "block_density_mean"):
        assert port.stats[key] == pytest.approx(ref.stats[key], rel=1e-6), key
    assert calls == {"tsar_sparse_padded": 7 * cfg.n_layers * port.stats["steps"],
                     "tsar_matmul": 0}


def test_reference_plan_from_json_and_all_mxu_plan_serve_same_tokens(sparse_ref,
                                                                     monkeypatch):
    ref, cfg = sparse_ref["ref"], sparse_ref["cfg"]
    params = _port_params(sparse_ref)
    loaded = ModelPlan.from_json(ref.plan.to_json())
    eng = ServingEngine(cfg, params, plan=loaded, device="cpu", **ENGINE_KW)
    assert eng.plan is loaded and eng.stats["plan_matched_layers"] == 7
    assert [r.out_tokens for r in eng.run(_requests(Request))] == sparse_ref["tokens"]

    mxu = ModelPlan(buckets=loaded.buckets, shapes=dict(loaded.shapes), layers={
        name: {n: dataclasses.replace(lp, kernel="tsar_mxu") for n, lp in by_n.items()}
        for name, by_n in loaded.layers.items()})
    sparse_calls = []
    inner = ops.tsar_sparse_padded_matmul
    monkeypatch.setattr(ops, "tsar_sparse_padded_matmul",
                        lambda *a, **kw: sparse_calls.append(1) or inner(*a, **kw))
    eng = ServingEngine(cfg, params, plan=mxu, device="cpu", **ENGINE_KW)
    assert [r.out_tokens for r in eng.run(_requests(Request))] == sparse_ref["tokens"]
    assert not sparse_calls


def test_plan_for_another_model_warns(sparse_ref):
    cfg = sparse_ref["cfg"]
    foreign = ModelPlan(buckets=(1,), shapes={"x": (4096, 4096, 4)}, layers={"x": {}})
    with pytest.warns(UserWarning, match="resolves only 0/7"):
        eng = ServingEngine(cfg, _port_params(sparse_ref), plan=foreign, device="cpu",
                            **ENGINE_KW)
    assert eng.stats["plan_matched_layers"] == 0


def test_density_telemetry_and_packed_fraction_match_reference(sparse_ref):
    params = _port_params(sparse_ref)
    mine = engine.density_telemetry(params)
    theirs = jengine.density_telemetry(sparse_ref["ref"].params)
    for key in ("layers", "density_mean", "density_min", "block_density_mean"):
        assert mine[key] == pytest.approx(theirs[key], rel=1e-6), key
    assert engine.packed_fraction(params) == pytest.approx(
        jengine.packed_fraction(sparse_ref["ref"].params), rel=1e-12)


def test_serve_cli_saves_loads_and_prints_plan(tmp_path, capsys):
    path = tmp_path / "plan.json"
    argv = ["--arch", "bitnet-2b-4t", "--smoke", "--device", "cpu", "--requests", "2",
            "--max-new", "2", "--sparse", "true", "--sparse-block", "64",
            "--plan-file", str(path), "--print-plan"]
    eng, reqs = serve.main(argv)
    assert path.exists() and all(r.done for r in reqs)
    assert "sp_sign" in eng.params["blocks"]["mlp"]["w_up"]
    out = capsys.readouterr().out
    assert "compiled and saved" in out and "| blocks/mlp/w_up" in out
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        eng2, reqs2 = serve.main(argv)
    assert "loaded" in capsys.readouterr().out
    assert eng2.plan == ModelPlan.load(path)
    assert [r.out_tokens for r in reqs2] == [r.out_tokens for r in reqs]
