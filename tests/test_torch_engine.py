"""Port vs reference: the serving engine end to end, and the port's
package rules.

The reference ``repro.serving.ServingEngine(packed=True)`` freezes a reduced
config; the port's engine serves the same frozen planes (carried across with
the bridge) on the CPU.  On the same requests the step-plan sequence, the
greedy tokens and the engine counters must be identical.  The comparison
relies on the reference step spelling every projection as the planes decode
-> int8 dot: a guard asserts that its plan names only ``tsar_mxu`` and that
it froze no ``sp_*`` pool leaves.  The windowed configs (reduced
``gemma2-2b``, ``gemma3-4b``) serve prompts longer than their window of 32.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_serving import assert_same_run, reference_latent, requests, run_pair

from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.plan import ModelPlan, registry, runtime
from repro_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_latent():
    return reference_latent("bitnet-2b-4t")


_MIXED = dict(max_len=64, batch_slots=2, prefill_chunk=8)
_TIGHT = dict(max_len=64, batch_slots=2, prefill_chunk=8, block_size=4, kv_blocks=16)
SCENARIOS = {
    # name: (arch, engine kwargs, prompt lengths, max_new_tokens, seed)
    "mixed": ("bitnet-2b-4t", _MIXED, [3, 8, 21, 40, 5], 5, 7),
    "preemption_storm": ("bitnet-2b-4t", _TIGHT, [30, 31, 32, 12], 6, 11),
    # Four prompts that share a 32-token prefix (made in _scenario_requests).
    "prefix_cache": ("bitnet-2b-4t", dict(_MIXED, max_len=128, prefix_cache=True),
                     [12, 9, 16, 5], 5, 3),
    "prefix_cache_storm": ("bitnet-2b-4t", dict(_TIGHT, prefix_cache=True),
                           [30, 31, 32, 12], 6, 11),
    "gemma2_window": ("gemma2-2b", _MIXED, [3, 40, 21, 55], 6, 5),
    "gemma3_window": ("gemma3-4b", _MIXED, [45, 8, 60], 6, 6),
    "qwen3_qk_norm": ("qwen3-32b", _MIXED, [3, 8, 21, 40], 5, 8),
}


def _scenario_requests(name, cls):
    _, _, lens, max_new, seed = SCENARIOS[name]
    reqs = requests(cls, lens, max_new, seed)
    if name == "prefix_cache":
        system = (np.arange(32, dtype=np.int32) * 5 + 1) % 90
        for r in reqs:
            r.prompt = np.concatenate([system, r.prompt])
    return reqs


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_matches_reference(scenario):
    arch, kw = SCENARIOS[scenario][:2]
    run = run_pair(arch, kw, lambda cls: _scenario_requests(scenario, cls))
    assert_same_run(*run)
    ref, port = run[0], run[1]
    if "storm" in scenario:
        assert port.stats["preemptions"] > 0, "pool not tight enough"
    if scenario.startswith("prefix_cache"):
        assert port.sched.cached_tokens_skipped > 0
    if "window" in scenario:
        assert max(len(r.prompt) for r in run[3]) > port.cfg.window_size


def test_temperature_sampling_is_seeded(ref_latent):
    cfg, latent = ref_latent
    frozen = JServingEngine(cfg, latent, packed=True, max_len=32, batch_slots=2).params
    params = bridge.params_from_reference(jax.tree.map(np.asarray, frozen), device="cpu")

    def run(seed):
        eng = ServingEngine(cfg, params, max_len=32, batch_slots=2, seed=seed, device="cpu")
        reqs = requests(Request, [5, 7], 4, 3)
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


def test_unknown_policy_raises(ref_latent):
    cfg, _ = ref_latent
    with pytest.raises(ValueError, match="policy"):
        ServingEngine(cfg, {}, device="cpu", policy="rectangular")


def test_plan_is_accepted_and_used(ref_latent, monkeypatch):
    """A supplied plan becomes the engine's plan, is active inside every
    step, and decides the kernel: pinning every layer to ``dense`` routes
    every projection through the registry's dense lowering."""
    cfg, latent = ref_latent
    frozen = JServingEngine(cfg, latent, packed=True, max_len=32, batch_slots=2).params
    params = bridge.params_from_reference(jax.tree.map(np.asarray, frozen), device="cpu")
    base = ServingEngine(cfg, params, max_len=32, batch_slots=2, device="cpu")
    dense = ModelPlan(buckets=base.plan.buckets, shapes=dict(base.plan.shapes), layers={
        name: {n: dataclasses.replace(lp, kernel="dense") for n, lp in by_n.items()}
        for name, by_n in base.plan.layers.items()})
    seen = []
    lower = registry.get("dense").lower
    monkeypatch.setattr(registry.get("dense"), "lower",
                        lambda *a, **kw: seen.append(runtime.current()) or lower(*a, **kw))
    eng = ServingEngine(cfg, params, max_len=32, batch_slots=2, plan=dense, device="cpu")
    assert eng.plan is dense and eng.stats["plan_matched_layers"] == 7
    reqs = eng.run(requests(Request, [5, 7], 3, 3))
    assert all(r.done for r in reqs)
    assert len(seen) == 7 * cfg.n_layers * eng.stats["steps"]
    assert all(p is dense for p in seen)
    assert runtime.current() is None


def _port_files():
    """The port's package, chip_smoke.py and the A/B tools that drive it on the
    card (none of them may need JAX there)."""
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    """Neither JAX, the reference package nor the benchmark harness."""
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
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
                f"{path}: imports {name}"


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
