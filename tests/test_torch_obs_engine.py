"""Port vs reference: the observability wiring of the serving engine.

The ``preemption-storm`` quick trace (reduced ``bitnet-2b-4t``, the
reference's latent params from ``PRNGKey(0)``) is replayed through the
reference's ``runner.run_workload(..., tracer=EventTracer())`` and through
the port's engine (the same params carried across and frozen by the port,
``_torch_serving.replay``).  Event structure is a pure function of (trace,
code), so the two structure fingerprints must be exactly equal; attaching
a tracer or an incident monitor must change no token and no counter; the
monitors of both packages must fire the same (trigger, context) sequence.
Then the engine options (``flight_recorder``, ``profiler_annotations``,
warm-up incidents) and ``launch/serve.py``'s observability flags, whose
files the reference's readers must accept.
"""
import contextlib
import json
import os
import tempfile
import time

import jax
import numpy as np
import pytest
import torch
from _torch_serving import (engine_counters, one_torch_thread, reference_latent,  # noqa: F401
                            replay, requests, workload_engine)

from benchmarks.workloads import runner
from benchmarks.workloads.generator import generate, preset
from repro.obs import incident as jincident
from repro.obs import timeline as jtimeline
from repro.obs import trace as jtrace
from repro_torch import bridge
from repro_torch.launch import serve
from repro_torch.obs import incident, timeline, trace
from repro_torch.serving import Request, ServingEngine, freeze_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _incidents(monitor, load) -> list:
    """(trigger, context) of every file ``monitor`` wrote, read back by
    ``load`` (either package's ``load_incident``)."""
    docs = [load(p) for p in monitor.paths]
    return [(d["trigger"], d["context"]) for d in docs]


@pytest.fixture(scope="module")
def storm():
    """The reference's traced replay (with an incident monitor) and three
    port replays: traced with a monitor, traced again, and untraced (on one
    torch thread, as ``one_torch_thread`` runs each test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _storm()
    finally:
        torch.set_num_threads(threads)


def _storm() -> dict:
    spec = preset("preemption-storm", quick=True)
    wl = generate(spec)
    cfg, latent = reference_latent("bitnet-2b-4t")
    out_dir = tempfile.mkdtemp(prefix="obs-storm-")
    jt = jtrace.EventTracer()
    jmon = jincident.IncidentMonitor(os.path.join(out_dir, "ref"))
    block, ref_engine, ref_reqs = runner.run_workload(spec, cfg, latent, trace=wl,
                                                      tracer=jt, incidents=jmon)
    params = freeze_params(bridge.params_from_reference(jax.tree.map(np.asarray, latent),
                                                        device="cpu"))
    runs = {}
    for label, kw in (("traced", {"tracer": trace.EventTracer(),
                                  "incidents": incident.IncidentMonitor(
                                      os.path.join(out_dir, "port"))}),
                      ("again", {"tracer": trace.EventTracer()}),
                      ("untraced", {})):
        engine = workload_engine(spec, cfg, params, **kw)
        runs[label] = engine, replay(engine, wl)[0]
    return {"ref": (jt, jmon, block, ref_engine, ref_reqs), "port": runs, "cfg": cfg,
            "params": params}


def _first_difference(a: list, b: list) -> str:
    sa, sb = jtrace.structure(a), jtrace.structure(b)
    i = next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y), min(len(sa), len(sb)))
    return (f"{len(sa)} vs {len(sb)} events; first difference at {i}: "
            f"{sa[i] if i < len(sa) else None} vs {sb[i] if i < len(sb) else None}")


def test_structure_fingerprint_equals_reference(storm):
    jt = storm["ref"][0]
    pt = storm["port"]["traced"][0].tracer
    assert (trace.structure_fingerprint(pt.events)
            == jtrace.structure_fingerprint(jt.events)), _first_difference(jt.events, pt.events)
    port_doc, ref_doc = pt.to_perfetto(rev="x"), jt.to_perfetto(rev="x")
    assert port_doc["otherData"] == ref_doc["otherData"]
    jtrace.validate(port_doc)
    trace.validate(ref_doc)
    names = {(e["ph"], e["name"]) for e in pt.events}
    for needed in (("n", "preempted"), ("n", "prefix_hit"), ("i", "kv_pressure"),
                   ("X", "step"), ("n", "finished")):
        assert needed in names, needed
    kernels = {e["args"]["kernel"] for e in pt.events if e["name"] == "step"}
    assert kernels == {"tsar_mxu"}


def test_tracer_and_monitor_change_no_token_or_counter(storm):
    runs = storm["port"]
    base_engine, base_reqs = runs["untraced"]
    assert base_engine.tracer is trace.NULL_TRACER and base_engine.incidents is None
    for label in ("traced", "again"):
        engine, reqs = runs[label]
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in base_reqs]
        assert engine_counters(engine) == engine_counters(base_engine)
    # and the port's counters are the reference's, traced both
    ref_engine = storm["ref"][3]
    assert engine_counters(runs["traced"][0]) == engine_counters(ref_engine)
    assert [r.out_tokens for r in runs["traced"][1]] == [r.out_tokens for r in storm["ref"][4]]


def test_two_port_replays_same_fingerprint(storm):
    a, b = (storm["port"][k][0].tracer for k in ("traced", "again"))
    assert trace.structure_fingerprint(a.events) == trace.structure_fingerprint(b.events)
    n_pre = sum(e["ph"] == "n" and e["name"] == "preempted" for e in a.events)
    assert n_pre == storm["port"]["traced"][0].stats["preemptions"] > 0


def test_timeline_of_the_replay_agrees_with_the_engine(storm):
    engine = storm["port"]["traced"][0]
    s = timeline.analyze(engine.tracer.to_perfetto(rev="x"))
    assert s["steps"]["n"] == engine.stats["steps"]
    assert s["steps"]["planned_tokens"] == engine.metrics.get("planned_tokens").value
    assert s["steps"]["realized_tokens"] == engine.metrics.get("realized_tokens").value
    assert s["preemptions"]["n"] == engine.stats["preemptions"]
    ref = jtimeline.analyze(storm["ref"][0].to_perfetto(rev="x"))
    for key in ("steps", "spans_us"):           # wall-clock sums differ
        s.pop(key), ref.pop(key)
    assert s == ref


def test_incident_sequences_equal_reference(storm):
    jmon = storm["ref"][1]
    mon = storm["port"]["traced"][0].incidents
    port_seq = _incidents(mon, jincident.load_incident)   # read by the other package
    ref_seq = _incidents(jmon, incident.load_incident)
    assert port_seq == ref_seq
    assert mon.summary()["by_trigger"] == jmon.summary()["by_trigger"]
    assert mon.suppressed == jmon.suppressed
    assert mon.fired.get("preemption", 0) >= 1


def test_warmup_incidents_discarded_by_reset_run_stats(storm):
    cfg, params = storm["cfg"], storm["params"]
    out_dir = tempfile.mkdtemp(prefix="obs-warm-")
    mon = incident.IncidentMonitor(out_dir, cooldown_steps=0)
    engine = ServingEngine(cfg, params, device="cpu", max_len=64, batch_slots=4,
                           prefill_chunk=8, kv_blocks=6, incidents=mon,
                           flight_recorder=True)
    engine.run(requests(Request, [20, 20, 20, 20], 8, seed=3))
    assert engine.stats["preemptions"] > 0
    assert mon.fired.get("preemption") == engine.stats["preemptions"]
    paths = list(mon.paths)
    assert paths and all(os.path.exists(p) for p in paths)
    doc = jincident.load_incident(paths[0])
    assert doc["ring"]["events"], "the flight recorder's ring reached the snapshot"
    engine.reset_run_stats()
    assert not any(os.path.exists(p) for p in paths)
    assert mon.summary() == {"n": 0, "by_trigger": {}, "suppressed": 0, "paths": []}
    assert os.listdir(out_dir) == []


def test_flight_recorder_gives_a_ring_tracer(storm):
    cfg, params = storm["cfg"], storm["params"]
    on = ServingEngine(cfg, params, device="cpu", flight_recorder=True)
    assert isinstance(on.tracer, trace.EventTracer)
    assert isinstance(on.tracer.sink, trace.RingSink)
    assert on.tracer.sink.capacity == trace.DEFAULT_RING_CAPACITY
    small = ServingEngine(cfg, params, device="cpu", flight_recorder=16)
    assert small.tracer.sink.capacity == 16
    small.run(requests(Request, [5, 7], 4, seed=0))
    assert len(small.tracer.events) == 16 and small.tracer.sink.n_dropped > 0
    given = trace.EventTracer()
    assert ServingEngine(cfg, params, device="cpu", tracer=given,
                         flight_recorder=True).tracer is given
    assert ServingEngine(cfg, params, device="cpu").tracer is trace.NULL_TRACER


def test_profiler_annotations_mark_every_step(storm):
    from torch.profiler import ProfilerActivity, profile

    cfg, params = storm["cfg"], storm["params"]
    engine = ServingEngine(cfg, params, device="cpu", profiler_annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run(requests(Request, [5, 9, 3], 3, seed=1))
    names = [e.name for e in prof.events() if e.name.startswith(trace.STEP_RANGE)]
    assert names == [f"{trace.STEP_RANGE}#{i}" for i in range(engine.stats["steps"])]
    plain = ServingEngine(cfg, params, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plain.run(requests(Request, [5, 9, 3], 3, seed=1))
    assert not any(e.name.startswith(trace.STEP_RANGE) for e in prof.events())


# The spans of a step (``obs.trace.span``): inside the model call, and the
# engine's host work beside it.
MODEL_SPANS = ("tsar.attn", "tsar.proj", "tsar.kv.gather", "tsar.kv.scatter", "tsar.kv.write",
               "tsar.kv.stack", "tsar.sync")
HOST_SPANS = ("tsar.admit", "tsar.plan", "tsar.upload", "tsar.sample", "tsar.emit")


def _profiled_run(cfg, params, annotations: bool, profiled: bool = True):
    """The engine (an ``EventTracer`` attached) over three requests, under a
    CPU ``torch.profiler`` when ``profiled``: (engine, requests, the
    profiler's (name, start_ns, end_ns) ranges, the wall seconds of every
    ``step()`` call)."""
    from torch.profiler import ProfilerActivity, profile

    engine = ServingEngine(cfg, params, device="cpu", profiler_annotations=annotations,
                           tracer=trace.EventTracer())
    reqs = requests(Request, [5, 9, 3], 3, seed=1)
    for r in reqs:
        engine.submit(r)
    walls, ranges = [], []
    prof = profile(activities=[ProfilerActivity.CPU])
    with prof if profiled else contextlib.nullcontext():
        while engine.busy:
            t = time.perf_counter()
            engine.step()
            walls.append(time.perf_counter() - t)
    if profiled:
        ranges = [(ev.name(), ev.start_ns(), ev.end_ns())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.name().startswith(("tsar.", trace.STEP_RANGE))]
    return engine, reqs, ranges, walls


@pytest.fixture(scope="module")
def spans_runs(storm):
    """Spans on and off under the profiler, and an untraced run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, params = storm["cfg"], storm["params"]
        return {"on": _profiled_run(cfg, params, True),
                "off": _profiled_run(cfg, params, False),
                "untraced": _profiled_run(cfg, params, False, profiled=False)}
    finally:
        torch.set_num_threads(threads)


def test_span_makes_no_range_unless_on_and_recording():
    from torch.profiler import ProfilerActivity, profile

    assert trace.span("attn") is trace._NO_RANGE
    with trace.spans():
        assert trace.span("attn") is trace._NO_RANGE           # no profiler records
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("attn") as rng:
                assert rng is not None
    assert trace.span("attn") is trace._NO_RANGE


def _inside(inner, outers) -> bool:
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


def test_spans_nest_inside_the_step(spans_runs):
    engine, _, ranges, _ = spans_runs["on"]
    by = {}
    for r in ranges:
        by.setdefault(r[0].split("#")[0], []).append(r)
    assert set(by) == set(MODEL_SPANS + HOST_SPANS) | {trace.STEP_RANGE}
    assert len(by[trace.STEP_RANGE]) == engine.stats["steps"]
    assert all(_inside(r, by["tsar.attn"]) for r in by["tsar.kv.write"])
    assert any(_inside(r, by["tsar.attn"]) for r in by["tsar.proj"])
    assert not all(_inside(r, by["tsar.attn"]) for r in by["tsar.proj"])   # the MLP's
    for name in MODEL_SPANS:
        assert all(_inside(r, by[trace.STEP_RANGE]) for r in by[name]), name
    for name in HOST_SPANS:
        assert not any(_inside(r, by[trace.STEP_RANGE]) for r in by[name]), name


def test_spans_off_record_nothing_and_change_no_token_or_counter(spans_runs):
    assert spans_runs["off"][2] == []
    base_engine, base_reqs = spans_runs["untraced"][:2]
    for label in ("on", "off"):
        engine, reqs = spans_runs[label][:2]
        assert [r.out_tokens for r in reqs] == [r.out_tokens for r in base_reqs]
        assert engine_counters(engine) == engine_counters(base_engine)


@pytest.mark.parametrize("label", ["on", "off", "untraced"])
def test_step_enqueue_and_host_within_the_step_wall(spans_runs, label):
    engine, _, _, walls = spans_runs[label]
    enqueue, host = engine.stats["step_enqueue_s"], engine.stats["step_host_s"]
    assert enqueue > 0 and host > 0
    assert enqueue <= engine.stats["prefill_s"] + engine.stats["decode_s"]
    assert enqueue + host <= sum(walls)


def test_tracer_anchor_puts_steps_on_the_profiler_clock(spans_runs):
    engine, _, ranges, _ = spans_runs["on"]
    starts = {int(n.split("#")[1]): s for n, s, _ in ranges if n.startswith(trace.STEP_RANGE)}
    steps = [e for e in engine.tracer.events if e["ph"] == "X" and e["name"] == "step"]
    assert len(steps) == len(starts) == engine.stats["steps"]
    for ev in steps:
        assert abs(engine.tracer.unix_ns(ev["ts"]) - starts[ev["args"]["step"]]) < 1e6


def test_serve_cli_writes_files_the_reference_accepts(tmp_path, capsys):
    """``repro_torch.launch.serve --smoke --device cpu`` with every
    observability flag: the reference's ``load``/``StreamReader``/
    ``timeline``/``validate_incident`` accept what it writes.  Prompts of
    4-11 tokens against ``--max-len 10`` reject the longest (a
    ``rejection`` incident)."""
    doc_path, stream_path = tmp_path / "t.json", tmp_path / "t.jsonl"
    inc_dir, prom = tmp_path / "inc", tmp_path / "m.prom"
    engine, reqs = serve.main([
        "--arch", "bitnet-2b-4t", "--smoke", "--device", "cpu", "--requests", "8",
        "--max-new", "3", "--max-len", "10", "--trace-out", str(doc_path),
        "--trace-stream", str(stream_path), "--incident-dir", str(inc_dir),
        "--metrics-textfile", str(prom), "--metrics-interval", "0.05",
        "--metrics-port", "0", "--profile-steps"])
    err = capsys.readouterr().err
    assert engine.stats["rejections"] > 0
    doc = jtrace.load(str(doc_path))
    events, reader = jtrace.read_stream(str(stream_path))
    assert reader.complete and reader.fingerprint == doc["otherData"]["fingerprint"]
    assert jtimeline.main([str(doc_path), "--require", "step", "prefill-span",
                           "decode-span"]) == 0
    assert jtimeline.main([str(stream_path), "--require", "step"]) == 0
    files = sorted(os.listdir(inc_dir))
    assert files and all("-rejection-" in f for f in files)
    for f in files:
        jincident.load_incident(str(inc_dir / f))
    from repro.obs.export import parse_samples
    samples = parse_samples(prom.read_text())
    assert samples["tsar_steps"] == engine.stats["steps"]
    assert samples["tsar_rejections"] == engine.stats["rejections"]
    chrome = json.loads((tmp_path / "t.torch.json").read_text())
    ranges = [e["name"] for e in chrome["traceEvents"]
              if str(e.get("name", "")).startswith(trace.STEP_RANGE)]
    assert len(ranges) == engine.stats["steps"]
    assert "incidents: " in err and "obs stream: " in err
