"""Port vs reference: the serving engine end to end, and the port's
package rules.

The reference ``repro.serving.ServingEngine(packed=True)`` freezes the
reduced ``bitnet-2b-4t``; the port's engine serves the same frozen planes
(carried across with the bridge) on the CPU.  On the same requests the
``FlatStepPlan`` sequence, the greedy tokens and the engine counters must be
identical.  The comparison relies on the reference step spelling every
projection as the planes decode -> int8 dot: a guard asserts that its plan
names only ``tsar_mxu`` and that it froze no ``sp_*`` pool leaves.
"""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import model_zoo as jzoo
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("steps", "prefill_tokens", "decode_tokens", "total_tokens",
            "peak_kv_blocks", "max_step_tokens", "preemptions")
PLAN_FIELDS = ("tokens", "slot", "pos", "lengths", "n_real", "emit", "emit_row",
               "width", "view_blocks", "prefill_mask", "prefill_tokens",
               "decode_tokens")


@pytest.fixture(scope="module")
def ref_latent():
    cfg = jconfigs.get("bitnet-2b-4t").reduced()
    return cfg, jzoo.init_params(cfg, jax.random.PRNGKey(0))


def _requests(cls, lens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, 100, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


def _record_plans(engine):
    plans = []
    inner = engine.sched.plan_flat

    def plan_flat(*args, **kw):
        plan = inner(*args, **kw)
        plans.append(plan)
        return plan

    engine.sched.plan_flat = plan_flat
    return plans


def _plan_key(plan):
    if not hasattr(plan, "tokens"):
        return ("preempt", plan.slot)
    return tuple(np.asarray(getattr(plan, f)).tolist() for f in PLAN_FIELDS)


SCENARIOS = {
    # name: (engine kwargs, prompt lengths, max_new_tokens, seed)
    "mixed": (dict(max_len=64, batch_slots=2, prefill_chunk=8), [3, 8, 21, 40, 5], 5, 7),
    "preemption_storm": (dict(max_len=64, batch_slots=2, prefill_chunk=8,
                              block_size=4, kv_blocks=16), [30, 31, 32, 12], 6, 11),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_reference(scenario, ref_latent):
    cfg, latent = ref_latent
    kw, lens, max_new, seed = SCENARIOS[scenario]
    ref = JServingEngine(cfg, latent, packed=True, policy="flat", **kw)

    # Guard: the reference step spells every projection as the planes
    # decode -> int8 dot only when the plan is tsar_mxu and no pools exist.
    kernels = {lp.kernel for by_n in ref.plan.layers.values() for lp in by_n.values()}
    assert kernels == {"tsar_mxu"}, kernels
    leaves = [getattr(k, "key", "") for path, _ in
              jax.tree_util.tree_flatten_with_path(ref.params)[0] for k in path]
    assert not any(str(name).startswith("sp_") for name in leaves)

    port = ServingEngine(cfg, bridge.params_from_reference(jax.tree.map(np.asarray, ref.params),
                                                            device="cpu"),
                         device="cpu", **kw)
    ref_plans, port_plans = _record_plans(ref), _record_plans(port)
    ref_reqs = ref.run(_requests(JRequest, lens, max_new, seed))
    port_reqs = port.run(_requests(Request, lens, max_new, seed))

    assert [_plan_key(p) for p in port_plans] == [_plan_key(p) for p in ref_plans]
    assert all(r.done for r in port_reqs)
    port.kv.check()
    assert port.kv.blocks_in_use == 0
    assert [r.out_tokens for r in port_reqs] == [r.out_tokens for r in ref_reqs]
    for key in COUNTERS:
        assert port.stats[key] == ref.stats[key], key
    if scenario == "preemption_storm":
        assert port.stats["preemptions"] > 0, "pool not tight enough"


def test_temperature_sampling_is_seeded(ref_latent):
    cfg, latent = ref_latent
    frozen = JServingEngine(cfg, latent, packed=True, max_len=32, batch_slots=2).params
    params = bridge.params_from_reference(jax.tree.map(np.asarray, frozen), device="cpu")

    def run(seed):
        eng = ServingEngine(cfg, params, max_len=32, batch_slots=2, seed=seed, device="cpu")
        reqs = _requests(Request, [5, 7], 4, 3)
        for r in reqs:
            r.temperature = 1.0
        return [r.out_tokens for r in eng.run(reqs)]

    first = run(0)
    assert first == run(0)
    assert all(0 <= t < cfg.vocab_size for toks in first for t in toks)


def test_cuda_device_raises_without_gpu(ref_latent):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    cfg, _ = ref_latent
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(cfg, {}, device="cuda")


@pytest.mark.parametrize("kw", [dict(plan=object()), dict(prefix_cache=True),
                                dict(policy="chunked"), dict(packed=False)])
def test_unported_options_raise(kw, ref_latent):
    cfg, _ = ref_latent
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServingEngine(cfg, {}, device="cpu", **kw)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    """Without a GPU (here) or outside a checkout, chip_smoke exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                              text=True, timeout=120, cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
