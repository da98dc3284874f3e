"""The quick workload suite replayed through the port's engine on the CPU:
the deterministic counters of every workload block equal the committed
baseline (``benchmarks/baselines/BENCH_e2e.baseline.json``) exactly.

As ``benchmarks.workloads.runner.run_suite`` builds them: the reduced
``bitnet-2b-4t``, latent params from the reference's ``init_params`` at
``PRNGKey(0)`` (carried across with the bridge and frozen once by the
port's ``freeze_params``, as each engine would freeze them),
``preset(name, quick=True, seed=0)`` traces, each replayed once per module
in virtual time after ``warmup``; ``shared-prefix-cold`` is the shared-prefix
trace with the cache off.  ``plan_kernel`` (the compiled plan's decode
kernel) is compared apart: the port plans with H100 constants.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
from _torch_serving import reference_latent, replay, workload_engine

from benchmarks.workloads import metrics
from benchmarks.workloads.generator import generate, preset
from repro_torch import bridge
from repro_torch.serving import Request, freeze_params

ROOT = Path(__file__).resolve().parents[1]
BASELINE = json.loads((ROOT / "benchmarks" / "baselines" / "BENCH_e2e.baseline.json")
                      .read_text())["workloads"]


@pytest.fixture(scope="module")
def replays():
    """name -> (engine, requests) of each baseline block's replay, run on
    first use; ``keep=False`` hands the pair over (a caller that goes on
    using the engine), and a later call replays again."""
    cfg, latent = reference_latent("bitnet-2b-4t")
    params = freeze_params(bridge.params_from_reference(jax.tree.map(np.asarray, latent),
                                                        device="cpu"))
    done = {}

    def run(name: str, keep: bool = True):
        if name not in done:
            spec = preset(name.removesuffix("-cold"), quick=True, seed=0)
            engine = workload_engine(spec, cfg, params,
                                     prefix_cache=False if name.endswith("-cold") else None)
            done[name] = engine, replay(engine, generate(spec))[0]
        return done[name] if keep else done.pop(name)

    return run


@pytest.mark.parametrize("name", sorted(BASELINE))
def test_counters_equal_baseline(name, replays):
    engine, reqs = replays(name)
    want = dict(BASELINE[name]["counters"])
    got = metrics.engine_counters(engine)
    assert want.pop("plan_kernel") == "tsar_mxu"
    assert got.pop("plan_kernel") == "tsar_mxu"
    assert got == want
    assert all(r.done for r in reqs)
    if engine.prefix is not None:
        engine.prefix.check()
        assert engine.kv.blocks_in_use == engine.prefix.cached_blocks
    if name == "shared-prefix":
        util = got["realized_tokens"] / got["planned_tokens"]
        assert round(100 * util, 1) == 91.3


def test_shared_prefix_warm_equals_cold(replays):
    """The runner's serving contract on the port: warm and cold replays of
    the shared-prefix trace give equal tokens, and the warm one schedules
    fewer prefill tokens."""
    warm, warm_reqs = replays("shared-prefix")
    cold, cold_reqs = replays("shared-prefix-cold")
    assert [r.out_tokens for r in warm_reqs] == [r.out_tokens for r in cold_reqs]
    assert warm.stats["prefix_hit_rate"] > 0
    assert warm.stats["prefill_tokens"] < cold.stats["prefill_tokens"]


def test_run_api(replays):
    """``warmup`` leaves an idle engine with zeroed run counters, rebased
    peaks and an empty prefix tree; ``latency_stats`` and
    ``max_step_tokens`` read the run."""
    engine, reqs = replays("preemption-storm", keep=False)
    stats = engine.latency_stats(reqs)
    assert stats["n"] == len(reqs) and stats["ttft_max_s"] >= stats["ttft_mean_s"] > 0
    assert engine.max_step_tokens() == engine.stats["max_step_tokens"] > 0
    assert engine.queue_len == 0
    engine.warmup(seq_len=20)
    assert engine.stats["steps"] == 0 and engine.stats["preemptions"] == 0
    assert engine.stats["peak_kv_blocks"] == engine.kv.blocks_in_use == 0
    assert engine.stats["cached_blocks"] == engine.stats["prefix_hit_tokens"] == 0
    assert engine.sched.readmissions == engine.sched.cached_tokens_skipped == 0
    engine.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(RuntimeError, match="idle"):
        engine.warmup()
