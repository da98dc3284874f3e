"""Port vs reference: the observability modules (``obs/trace``,
``obs/export``, ``obs/incident``, ``obs/timeline``), the step annotation and
``sparse/stats.format_report``.

A numpy-seeded op sequence goes into both packages' recorders with the same
injected clock.  The two must give equal documents, streams, analyses,
summary text, CLI exit codes, exposition text and incident files, and each
package must read and validate the other's files: the port keeps the
reference's on-disk formats (``OBS_TRACE`` v1, ``OBS_TRACE_STREAM`` v1,
``OBS_INCIDENT`` v1, Prometheus text 0.0.4).
"""
import json
import os
import tempfile
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st
from _torch_serving import port_params, reference_frozen

from repro.obs import export as jexport
from repro.obs import incident as jincident
from repro.obs import metrics as jmetrics
from repro.obs import timeline as jtimeline
from repro.obs import trace as jtrace
from repro.sparse import stats as jstats
from repro_torch.obs import export, incident, metrics, timeline, trace
from repro_torch.sparse import stats

REF = SimpleNamespace(trace=jtrace, export=jexport, incident=jincident, metrics=jmetrics,
                      timeline=jtimeline)
PORT = SimpleNamespace(trace=trace, export=export, incident=incident, metrics=metrics,
                       timeline=timeline)
PKGS = {"ref": REF, "port": PORT}
SEEDS = (0, 1, 2)


def _tick():
    t = [0.0]

    def clock():
        t[0] += 0.25
        return t[0]

    return clock


def _ops(seed: int, n: int = 160) -> list:
    """A numpy-seeded sequence of (op, uid, value) emissions."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, 5)), int(rng.integers(0, 6)), int(rng.integers(0, 48)))
            for _ in range(n)]


_SPANS = ("req", "queued", "prefill", "decode")
_MARKS = ("admitted", "prefix_hit", "first_token", "preempted", "finished", "prefill_chunk")
_INSTANTS = ("kv_pressure", "prefix_evict", "prefix_insert")


def _emit(tr, ops: list) -> None:
    for i, (op, uid, v) in enumerate(ops):
        if op == 0:
            tr.begin(uid, _SPANS[v % 4], prompt_len=v, max_new_tokens=v % 7)
        elif op == 1:
            tr.end(uid, _SPANS[v % 4], **({"preempted": True} if v % 5 == 0 else {}))
        elif op == 2:
            tr.mark(uid, _MARKS[v % 6], slot=v % 4, cached_len=v, readmission=v % 3 == 0)
        elif op == 3:
            tr.instant(_INSTANTS[v % 3], slot=v % 4, need=v % 5, free=0, n=v % 3,
                       cause=("capacity", "pressure")[v % 2])
        else:
            tr.step(v * 1e-4, step=i, planned=v + 4, realized=v,
                    prefill_tokens=(v % 3) * 4, decode_tokens=4, kv_blocks=v,
                    active_slots=v % 5, kernel=("tsar_mxu", None)[v % 7 == 0])


def _traced(pkg, seed: int, sink=None):
    tr = pkg.trace.EventTracer(clock=_tick(), sink=sink)
    _emit(tr, _ops(seed))
    return tr


def _stream(pkg, path: str, seed: int, finalize: bool = True, **kw):
    sink = pkg.trace.StreamingSink(path, rev="x", **kw)
    _traced(pkg, seed, sink)
    if finalize:
        sink.finalize()
    else:
        sink.flush()
    return sink


# ---------------------------------------------------------------------------
# trace documents
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_document_equal_to_reference(seed):
    port_doc = _traced(PORT, seed).to_perfetto(rev="x")
    ref_doc = _traced(REF, seed).to_perfetto(rev="x")
    assert trace.dumps(port_doc) == jtrace.dumps(ref_doc)
    assert port_doc["otherData"]["fingerprint"] == ref_doc["otherData"]["fingerprint"]
    jtrace.validate(port_doc)
    trace.validate(ref_doc)


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_saved_document_read_by_either_package(writer, tmp_path):
    path = str(tmp_path / "t.json")
    doc = _traced(PKGS[writer], 0).save(path, rev="x")
    for pkg in PKGS.values():
        assert pkg.trace.load(path) == doc
        kind, obj = pkg.trace.load_any(path)
        assert kind == "doc" and obj == doc


def test_meta_events_structure_and_constants_equal():
    assert trace.meta_events() == jtrace.meta_events()
    for name in ("TRACE_KIND", "TRACE_SCHEMA_VERSION", "STREAM_KIND",
                 "STREAM_SCHEMA_VERSION", "DEFAULT_RING_CAPACITY"):
        assert getattr(trace, name) == getattr(jtrace, name), name
    evs = _traced(PORT, 1).events
    assert trace.structure(evs) == jtrace.structure(evs)
    assert trace.structure_fingerprint(evs) == jtrace.structure_fingerprint(evs)
    assert trace.git_rev() == jtrace.git_rev()


def _tamperings():
    def drop_key(d):
        del d["otherData"]["git_rev"]

    def bad_phase(d):
        d["traceEvents"][5]["ph"] = "Q"

    def bad_kind(d):
        d["otherData"]["kind"] = "OTHER"

    def bad_schema(d):
        d["otherData"]["schema_version"] = 2

    def reorder(d):
        evs = d["traceEvents"]
        evs[4], evs[9] = evs[9], evs[4]

    def arg_edit(d):
        next(e for e in d["traceEvents"] if e["ph"] == "X")["args"]["planned"] += 1

    def no_dur(d):
        del next(e for e in d["traceEvents"] if e["ph"] == "X")["dur"]

    def async_no_id(d):
        del next(e for e in d["traceEvents"] if e["ph"] == "b")["id"]

    return [drop_key, bad_phase, bad_kind, bad_schema, reorder, arg_edit, no_dur,
            async_no_id]


@pytest.mark.parametrize("tamper", _tamperings(), ids=lambda f: f.__name__)
def test_validate_rejects_tampering_as_the_reference(tamper):
    errors = {}
    for name, pkg in PKGS.items():
        doc = _traced(pkg, 2).to_perfetto(rev="x")
        tamper(doc)
        with pytest.raises(ValueError) as e:
            pkg.trace.validate(doc)
        errors[name] = str(e.value)
    assert errors["port"] == errors["ref"]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seg", (1 << 30, 2048, 700))
@pytest.mark.parametrize("writer", sorted(PKGS))
def test_stream_read_by_either_package(writer, seg):
    d = tempfile.mkdtemp(prefix="obs-torch-stream-")
    path = os.path.join(d, "t.jsonl")
    info = _stream(PKGS[writer], path, 0, max_segment_bytes=seg, flush_every=5).finalize()
    memory_fp = _traced(REF, 0).to_perfetto(rev="x")["otherData"]["fingerprint"]
    assert info["fingerprint"] == memory_fp
    assert (info["segments"] > 1) == (seg < 1 << 30)
    got = {}
    for name, pkg in PKGS.items():
        assert pkg.trace.stream_segments(path) == jtrace.stream_segments(path)
        evs, r = pkg.trace.read_stream(path)
        assert r.complete and r.fingerprint == memory_fp and r.n_events == len(evs)
        kind, _ = pkg.trace.load_any(path)
        assert kind == "stream"
        got[name] = (evs, r.header, r.footer, pkg.trace.stream_to_perfetto(path))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_truncated_stream_read_alike(writer):
    """A writer that died mid-line: no footer, a partial last line in the
    active segment.  Both readers keep every whole event and report the
    stream incomplete."""
    d = tempfile.mkdtemp(prefix="obs-torch-trunc-")
    path = os.path.join(d, "t.jsonl")
    _stream(PKGS[writer], path, 1, finalize=False, max_segment_bytes=1500)
    with open(path, "a") as f:
        f.write('{"ph": "n", "cat": "req", "na')
    got = {}
    for name, pkg in PKGS.items():
        evs, r = pkg.trace.read_stream(path)
        assert r.complete is False
        got[name] = (evs, r.fingerprint, r.n_events)
    assert got["port"] == got["ref"]


def _stream_tamperings():
    def rotated_arg(path):
        seg = f"{path}.1"
        lines = open(seg).read().splitlines()
        i = next(i for i, ln in enumerate(lines) if '"ph":"X"' in ln)
        e = json.loads(lines[i])
        e["args"]["planned"] += 1
        lines[i] = json.dumps(e, sort_keys=True, separators=(",", ":"))
        open(seg, "w").write("\n".join(lines) + "\n")

    def rotated_garbage(path):
        with open(f"{path}.1", "a") as f:
            f.write("not json\n")

    def footer_count(path):
        lines = open(path).read().splitlines()
        foot = json.loads(lines[-1])
        foot["n_events"] += 1
        lines[-1] = json.dumps(foot, sort_keys=True, separators=(",", ":"))
        open(path, "w").write("\n".join(lines) + "\n")

    def bad_header(path):
        lines = open(path).read().splitlines()
        head = json.loads(lines[0])
        head["stream_version"] = 9
        lines[0] = json.dumps(head)
        open(path, "w").write("\n".join(lines) + "\n")

    return [rotated_arg, rotated_garbage, footer_count, bad_header]


@pytest.mark.parametrize("tamper", _stream_tamperings(), ids=lambda f: f.__name__)
def test_stream_reader_rejects_tampering_as_the_reference(tamper):
    d = tempfile.mkdtemp(prefix="obs-torch-tamper-")
    path = os.path.join(d, "t.jsonl")
    _stream(PORT, path, 2, max_segment_bytes=1500)
    tamper(path)
    errors = {}
    for name, pkg in PKGS.items():
        with pytest.raises(ValueError) as e:
            pkg.trace.read_stream(path)
        errors[name] = str(e.value)
    assert errors["port"] == errors["ref"]


def test_streaming_reset_and_sinks_behave_as_the_reference():
    got = {}
    for name, pkg in PKGS.items():
        d = tempfile.mkdtemp(prefix="obs-torch-reset-")
        path = os.path.join(d, "t.jsonl")
        sink = pkg.trace.StreamingSink(path, rev="x", max_segment_bytes=900, flush_every=3)
        ring, mem = pkg.trace.RingSink(40), pkg.trace.MemorySink()
        tr = pkg.trace.EventTracer(clock=_tick(), sink=pkg.trace.TeeSink(mem, ring, sink))
        _emit(tr, _ops(3, 60))                  # warm-up, then reset: truncated away
        tr.reset()
        assert not os.path.exists(f"{path}.1")
        _emit(tr, _ops(4, 50))
        info = sink.finalize()
        got[name] = (info["fingerprint"], info["n_events"], info["segments"],
                     len(tr.events), ring.n_dropped, ring.recent(10), sink.recent(7),
                     sink.peak_resident_events, jtrace.read_stream(path)[0])
        with pytest.raises(RuntimeError):
            sink.events
    assert got["port"] == got["ref"]


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6),
       flush=st.integers(min_value=1, max_value=9),
       seg=st.integers(min_value=256, max_value=8192))
def test_port_stream_reads_as_reference_memory(seed, flush, seg):
    """Any op sequence streamed by the port (any flush cadence and rotation
    threshold) fingerprints and analyzes, read by the reference, as the
    reference's in-memory document of the same ops."""
    d = tempfile.mkdtemp(prefix="obs-torch-prop-")
    path = os.path.join(d, "t.jsonl")
    _stream(PORT, path, seed, max_segment_bytes=seg, flush_every=flush)
    doc = _traced(REF, seed).to_perfetto(rev="x")
    s = jtimeline.analyze_stream(path)
    s.pop("stream")
    assert s == jtimeline.analyze(doc)
    assert timeline.analyze_stream(path)["fingerprint"] == doc["otherData"]["fingerprint"]


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_analysis_and_text_equal(seed):
    docs = {name: _traced(pkg, seed).to_perfetto(rev="x") for name, pkg in PKGS.items()}
    sums = {name: PKGS[name].timeline.analyze(doc) for name, doc in docs.items()}
    assert sums["port"] == sums["ref"]
    assert sums["port"]["preemptions"]["n"] > 0 and sums["port"]["steps"]["n"] > 0
    assert timeline.format_summary(sums["port"]) == jtimeline.format_summary(sums["ref"])
    evs = docs["port"]["traceEvents"]
    assert timeline.analyze_events(evs) == jtimeline.analyze_events(evs)


def test_timeline_of_an_empty_trace_equal():
    docs = {name: pkg.trace.EventTracer(clock=_tick()).to_perfetto(rev="x")
            for name, pkg in PKGS.items()}
    s = timeline.analyze(docs["port"])
    assert s == jtimeline.analyze(docs["ref"])
    assert s["steps"]["budget_utilization"] is None
    assert timeline.format_summary(s) == jtimeline.format_summary(s)


_CLI_ARGS = (["--require", "step", "prefill-span", "decode-span"],
             ["--require", "preemption", "prefix-hit"],
             ["--json"],
             ["--min-step-utilization", "0.5"],
             ["--min-step-utilization", "0.99"])


@pytest.mark.parametrize("empty", (False, True), ids=("ops", "empty"))
@pytest.mark.parametrize("fmt", ("json", "jsonl"))
def test_timeline_cli_exit_codes_and_output_equal(fmt, empty, tmp_path, capsys):
    path = str(tmp_path / f"t.{fmt}")
    if fmt == "json":
        tr = PORT.trace.EventTracer(clock=_tick())
        if not empty:
            _emit(tr, _ops(0))
        tr.save(path, rev="x")
    else:
        sink = PORT.trace.StreamingSink(path, rev="x")
        tr = PORT.trace.EventTracer(clock=_tick(), sink=sink)
        if not empty:
            _emit(tr, _ops(0))
        sink.finalize()
    codes = []
    for args in _CLI_ARGS:
        rc = {}
        out = {}
        for name, pkg in PKGS.items():
            rc[name] = pkg.timeline.main([path] + args)
            out[name] = capsys.readouterr()
        assert rc["port"] == rc["ref"], args
        assert out["port"].out == out["ref"].out and out["port"].err == out["ref"].err
        codes.append(rc["port"])
    assert codes == ([1, 1, 0, 1, 1] if empty else [0, 0, 0, 0, 1])


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _registry(pkg, seed: int = 0):
    rng = np.random.default_rng(seed)
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("steps", "engine steps").inc(int(rng.integers(1, 50)))
    g = reg.gauge("kv_blocks", "blocks in use")
    for v in rng.integers(0, 30, size=5):
        g.set(int(v))
    fam = reg.counter("step_time_s", "step wall", labels=("phase",))
    fam.labels(phase="prefill").inc(float(rng.random()))
    fam.labels(phase="decode").inc(float(rng.random()))
    h = reg.histogram("ttft_s", "time to first token\nin s")
    for v in rng.exponential(0.05, size=17):
        h.observe(float(v))
    reg.histogram("tpot_s", 'per-token "latency"')
    reg.gauge("hit_rate", "a ratio").set(float(rng.random()))
    return reg


@pytest.mark.parametrize("namespace", ("tsar", ""))
@pytest.mark.parametrize("seed", SEEDS)
def test_render_equal_to_reference(seed, namespace):
    text = export.render(_registry(PORT, seed), namespace)
    assert text == jexport.render(_registry(REF, seed), namespace)
    assert export.parse_samples(text) == jexport.parse_samples(text)
    assert export.NAMESPACE == jexport.NAMESPACE
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


def test_metrics_server_and_textfile_serve_the_render(tmp_path):
    reg = _registry(PORT, 1)
    want = jexport.render(_registry(REF, 1))
    srv = export.start_server(reg, port=0)
    writer = export.TextfileWriter(reg, str(tmp_path / "m.prom"), interval_s=0.01)
    try:
        assert srv.host == "127.0.0.1"
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert r.read().decode() == want
        with urllib.request.urlopen(srv.url + ".json", timeout=10) as r:
            assert json.loads(r.read()) == json.loads(json.dumps(reg.snapshot()))
        writer.start()
    finally:
        srv.stop()
        writer.stop()
    assert writer.n_writes >= 1
    assert (tmp_path / "m.prom").read_text() == want
    assert jexport.parse_samples(want)["tsar_steps"] == reg.get("steps").value


# ---------------------------------------------------------------------------
# incidents
# ---------------------------------------------------------------------------

def _monitor_run(pkg, out_dir: str) -> tuple:
    """The same hook sequence into one package's monitor, bound to its
    registry and a ring tracer fed the same ops."""
    tr = pkg.trace.EventTracer(clock=_tick(), sink=pkg.trace.RingSink(32))
    _emit(tr, _ops(5, 50))
    mon = pkg.incident.IncidentMonitor(out_dir, slo_ttft_s=0.5, slo_tpot_s=0.1,
                                       eviction_storm_n=4, eviction_window_steps=3,
                                       cooldown_steps=2, max_incidents=20, ring_limit=20,
                                       clock=lambda: 1.7e9)
    mon.bind(registry=_registry(pkg, 2), tracer=tr)
    rng = np.random.default_rng(7)
    for step in range(40):
        kind = int(rng.integers(0, 6))
        req = SimpleNamespace(uid=step, ttft=float(rng.random()), tpot=float(rng.random()) / 4)
        if kind == 0:
            mon.observe("preemption", uid=step, slot=step % 4, cursor=step * 3, n_preempted=1)
        elif kind == 1:
            mon.observe("kv_pressure", slot=step % 4, need=2, free=0)
        elif kind == 2:
            mon.request_first_token(req)
        elif kind == 3:
            mon.request_finished(req)
        elif kind == 4:
            mon.observe("rejection", n=1, queue_len=step)
        mon.step_tick(evictions=int(rng.integers(0, 3)))
    return mon, tr


def test_incident_files_equal_to_reference():
    docs, names, sums = {}, {}, {}
    for name, pkg in PKGS.items():
        mon, _ = _monitor_run(pkg, tempfile.mkdtemp(prefix=f"obs-torch-inc-{name}-"))
        sums[name] = {k: v for k, v in mon.summary().items() if k != "paths"}
        names[name] = [os.path.basename(p).rsplit("-", 1)[0] for p in mon.paths]
        # each package reads the other's files
        other = PKGS["ref" if name == "port" else "port"]
        docs[name] = [other.incident.load_incident(p) for p in mon.paths]
        for d in docs[name]:
            assert d.pop("created_unix") == 1.7e9
            d.pop("git_rev")
    assert sums["port"] == sums["ref"] and sums["port"]["suppressed"] > 0
    assert set(sums["port"]["by_trigger"]) == set(incident.TRIGGERS)
    assert names["port"] == names["ref"]
    assert docs["port"] == docs["ref"]
    assert incident.TRIGGERS == jincident.TRIGGERS
    assert incident.INCIDENT_KIND == jincident.INCIDENT_KIND


def test_incident_validation_and_reset_as_the_reference():
    errors = {}
    for name, pkg in PKGS.items():
        d = tempfile.mkdtemp(prefix=f"obs-torch-incv-{name}-")
        mon, _ = _monitor_run(pkg, d)
        doc = json.loads(open(mon.paths[0]).read())
        errs = []
        for key, val in (("trigger", "nope"), ("kind", "X"), ("schema_version", 2),
                         ("context", []), ("ring", {"n": 1}), ("metrics", None)):
            bad = dict(doc, **{key: val})
            with pytest.raises(ValueError) as e:
                pkg.incident.validate_incident(bad)
            errs.append(str(e.value))
        bad = dict(doc)
        del bad["seq"]
        with pytest.raises(ValueError) as e:
            pkg.incident.validate_incident(bad)
        errs.append(str(e.value))
        with pytest.raises(ValueError):
            pkg.incident.IncidentMonitor(d, triggers=("preemption", "bogus"))
        errors[name] = errs
        mon.reset_run()
        assert os.listdir(d) == [] and mon.summary()["n"] == 0
    assert errors["port"] == errors["ref"]


# ---------------------------------------------------------------------------
# the step annotation, format_report
# ---------------------------------------------------------------------------

def test_step_annotation_recorded_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in (3, 4, 5):
            with trace.step_annotation(i):
                torch.ones(4).add_(1)
    ranges = [e for e in prof.events() if e.name.startswith(trace.STEP_RANGE)]
    assert [e.name for e in ranges] == [f"tsar_engine_step#{i}" for i in (3, 4, 5)]
    assert all(any(c.name == "aten::add_" for c in e.cpu_children) for e in ranges)
    with trace.step_annotation(0):          # outside a profiler: a plain context
        pass


def test_format_report_equal_to_reference():
    _, frozen = reference_frozen("bitnet-2b-4t")
    ref_profile = jstats.profile_params(frozen, bk=128, bm=128)
    profile = stats.profile_params(port_params("bitnet-2b-4t"), bk=128, bm=128)
    text = stats.format_report(profile)
    assert text == jstats.format_report(ref_profile)
    assert stats.format_report(ref_profile) == jstats.format_report(ref_profile)
    assert len(text.splitlines()) == 2 + len(profile) == 2 + 7
