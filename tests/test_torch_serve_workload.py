"""Port vs reference: trace-driven serving (``repro_torch.workloads`` and
``launch/serve.py --workload/--trace-file/--seed``).

The port's generator gives the reference generator's traces byte for byte
(canonical JSON and fingerprint) for every preset, both sizes and two
seeds; specs and traces round-trip through files either package reads;
the metrics and counters of one replay equal the reference's functions on
the same requests; ``serve.main(--smoke --workload W)`` prints the
reference CLI's fingerprint prefix and counters (``plan_kernel`` apart: the
port plans with H100 constants); a saved trace replays to the same
counters; an unadmittable spec raises in both runners; and on the
reference's frozen params carried across, the ``steady`` replay gives the
reference runner's plans, greedy tokens and counters.
"""
import json
import re
import sys

import pytest
from _torch_serving import (assert_same_run, one_torch_thread, port_params,  # noqa: F401
                            record_plans, reference_latent)

import repro.launch.serve as jserve
from benchmarks.workloads import generator as jgenerator
from benchmarks.workloads import metrics as jmetrics
from benchmarks.workloads import runner as jrunner
from benchmarks.workloads.trace import Trace as JTrace
from repro_torch.launch import serve
from repro_torch.workloads import WORKLOADS, Trace, WorkloadSpec, generate, metrics, preset, runner

ARCH = "bitnet-2b-4t"
# The serve CLI's counters line; plan_kernel is the plan's decode kernel,
# picked by each package's own hardware constants.
COUNTERS_LINE = re.compile(r"^counters: (.*) plan_kernel=\S+$", re.M)
FINGERPRINT = re.compile(r"^trace: .*(sha256:[0-9a-f]{11})…\)$", re.M)


def test_presets_are_the_references():
    assert WORKLOADS == jgenerator.WORKLOADS


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("name", sorted(jgenerator.WORKLOADS))
def test_trace_bytes_equal_reference(name, quick, seed):
    spec = preset(name, quick=quick, seed=seed)
    assert spec.to_dict() == jgenerator.preset(name, quick=quick, seed=seed).to_dict()
    got, want = generate(spec), jgenerator.generate(jgenerator.preset(name, quick=quick,
                                                                      seed=seed))
    assert got.to_json() == want.to_json()
    assert got.fingerprint() == want.fingerprint()


def test_spec_and_trace_round_trip(tmp_path):
    """Through a file, and across the packages: a trace saved by either
    loads in the other with the same fingerprint."""
    spec = preset("shared-prefix", seed=5)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec.to_dict()))
    assert WorkloadSpec.from_dict(json.loads(spec_path.read_text())) == spec
    assert jgenerator.WorkloadSpec.from_dict(json.loads(spec_path.read_text())).to_dict() \
        == spec.to_dict()
    trace = generate(spec)
    path = tmp_path / "t.json"
    trace.save(str(path))
    again = Trace.load(str(path))
    assert again.to_json() == trace.to_json()
    assert JTrace.load(str(path)).fingerprint() == trace.fingerprint()
    jgenerator.generate(jgenerator.preset("mixed", seed=2)).save(str(path))
    assert Trace.load(str(path)).fingerprint() == generate(preset("mixed", seed=2)).fingerprint()
    assert again.n_requests == 8
    assert again.total_prompt_tokens() == 8 * 64
    with pytest.raises(ValueError, match="version"):
        Trace.from_dict(dict(trace.to_dict(), version=0))


@pytest.fixture(scope="module")
def storm_replay():
    """The quick preemption-storm trace through the port's
    ``runner.run_workload`` on the reference's frozen params (carried
    across): (spec, trace, report block, engine, requests)."""
    spec = preset("preemption-storm", quick=True)
    cfg, _ = reference_latent(ARCH)
    block, engine, reqs = runner.run_workload(spec, cfg, port_params(ARCH), device="cpu")
    return spec, generate(spec), block, engine, reqs


def test_metrics_and_counters_equal_reference(storm_replay):
    """The port's metrics on the port's replay equal the reference's
    functions on the same requests and engine."""
    _, trace, block, engine, reqs = storm_replay
    wall = block["metrics"]["wall_s"]
    assert all(r.done for r in reqs)
    assert block["metrics"] == metrics.latency_metrics(reqs, trace, wall)
    for scale in (1.0, 0.01):
        got = metrics.latency_metrics(reqs, trace, wall, scale)
        want = jmetrics.latency_metrics(reqs, trace, wall, scale)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert metrics.latency_metrics(reqs, trace, wall, 0.0)["goodput"]["good"] == 0
    got = metrics.engine_counters(engine)
    assert got == jmetrics.engine_counters(engine)
    assert got["preemptions"] > 0 and got["prefix_hit_rate"] > 0
    assert json.dumps(metrics.percentile_summary([])) == json.dumps(
        jmetrics.percentile_summary([]))


def test_run_workload_block(storm_replay):
    """``run_workload``'s block: the trace's fingerprint, the spec, the
    engine's counters, every request counted."""
    spec, trace, block, engine, reqs = storm_replay
    assert block["trace_fingerprint"] == trace.fingerprint()
    assert block["counters"] == metrics.engine_counters(engine)
    assert block["spec"] == spec.to_dict()
    assert block["metrics"]["goodput"]["total"] == len(reqs) == trace.n_requests
    assert [r.uid for r in reqs] == [t.uid for t in trace.requests]


def _counters(text: str) -> tuple:
    m, f = COUNTERS_LINE.search(text), FINGERPRINT.search(text)
    assert m and f, text
    return f.group(1), m.group(1)


@pytest.mark.parametrize("workload", ["steady", "preemption-storm"])
def test_serve_cli_equals_reference(workload, one_torch_thread, capsys,  # noqa: F811
                                    monkeypatch):
    serve.main(["--arch", ARCH, "--smoke", "--workload", workload, "--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke",
                                      "--workload", workload])
    jserve.main()
    want = capsys.readouterr().out
    assert _counters(got) == _counters(want)
    assert "goodput" in got and "TTFT p50/p90/p99" in got


def test_trace_file_saves_then_loads(tmp_path, one_torch_thread, capsys):  # noqa: F811
    path = str(tmp_path / "steady.json")
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--trace-file", path]
    first, _ = serve.main(argv + ["--workload", "steady", "--seed", "3"])
    saved = capsys.readouterr().out
    assert f"trace: saved to {path}" in saved
    again, _ = serve.main(argv)
    loaded = capsys.readouterr().out
    assert f"trace: loaded {path}" in loaded
    assert _counters(saved) == _counters(loaded)
    assert metrics.engine_counters(first) == metrics.engine_counters(again)
    assert Trace.load(path).fingerprint() == generate(preset("steady", quick=True,
                                                             seed=3)).fingerprint()
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--trace-file",
                    str(tmp_path / "missing.json")])


def test_unadmittable_spec_raises_in_both():
    """A pool of 3 blocks of 4 tokens is below the admission gate (a first
    chunk of 16 tokens and one more): both runners raise on the idle engine
    instead of spinning."""
    spec = WorkloadSpec(name="too-tight", n_requests=2, arrival={"kind": "burst"},
                        prompt_len={"kind": "fixed", "value": 24},
                        output_len={"kind": "fixed", "value": 4},
                        engine={"slots": 2, "prefill_chunk": 16, "max_len": 64,
                                "block_size": 4, "kv_blocks": 4})
    cfg, latent = reference_latent(ARCH)
    engine = runner.build_engine(spec, cfg, port_params(ARCH), device="cpu")
    with pytest.raises(RuntimeError, match="cannot be admitted on an idle engine"):
        runner.replay(engine, generate(spec), warmup=False)
    jspec = jgenerator.WorkloadSpec.from_dict(spec.to_dict())
    jengine = jrunner.build_engine(jspec, cfg, latent)
    with pytest.raises(RuntimeError, match="cannot be admitted on an idle engine"):
        jrunner.replay(jengine, jgenerator.generate(jspec), warmup=False)


def test_steady_tokens_equal_reference_runner(one_torch_thread):  # noqa: F811
    """On the reference's frozen params carried across, the ``steady``
    replay's plans, greedy tokens and counters are the reference
    runner's."""
    spec = preset("steady", quick=True)
    cfg, latent = reference_latent(ARCH)
    ref = jrunner.build_engine(jgenerator.preset("steady", quick=True), cfg, latent)
    port = runner.build_engine(spec, cfg, port_params(ARCH), device="cpu")
    ref_plans, port_plans = record_plans(ref), record_plans(port)
    ref_reqs, _ = jrunner.replay(ref, jgenerator.generate(jgenerator.preset("steady",
                                                                            quick=True)))
    port_reqs, _ = runner.replay(port, generate(spec))
    assert_same_run(ref, port, ref_reqs, port_reqs, ref_plans, port_plans)
    assert metrics.engine_counters(port) == dict(
        jmetrics.engine_counters(ref), plan_kernel=metrics.engine_counters(port)["plan_kernel"])
