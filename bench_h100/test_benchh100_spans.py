"""The program's spans in the profiled slice (``h100bench.spans``): device
seconds by the span a kernel was launched in, tied by correlation id; idle
seconds by the span open at each instant of a gap; launch counts; and the
five readers that use them or the engine's step counters."""
from types import SimpleNamespace

import pytest

from h100bench import profile, spans, spec

MS = 1_000_000
READERS = ("attn_ms.chat", "kv_view_ms.chat", "launches_step.chat",
           "step_enqueue_ms.chat", "step_host_ms.chat")


def _events():
    """Two steps of 100 ms.  The first runs a model call with the
    attention's spans; the second has no program span.  Rows: (name,
    is_device, start, end, correlation id, linked correlation id)."""
    host = [("bench.step", 0, 100, 1), ("bench.step", 100, 200, 2),
            ("tsar_engine_step#7", 5, 95, 3), ("tsar.attn", 10, 50, 10),
            ("tsar.proj", 12, 20, 11), ("tsar.kv.write", 30, 35, 12),
            ("aten::mm", 40, 45, 20), ("tsar.sync", 60, 95, 13),
            ("tsar.sample", 96, 98, 14)]
    calls = [("cudaLaunchKernel", 13, 14, 1001, 11), ("cuLaunchKernel", 31, 32, 1003, 0),
             ("cudaLaunchKernel", 41, 42, 1002, 20), ("cudaDeviceSynchronize", 61, 95, 1004, 13)]
    device = [("tsar_matmul_kernel", 15, 25, 1001, 11),     # launched in tsar.proj
              ("gemm", 55, 70, 1002, 20),                   # aten::mm in tsar.attn, runs under sync
              ("index_copy", 65, 80, 1003, 0),              # its launch call only; 65-70 overlaps gemm
              ("orphan", 150, 160, 9999, 0),                # no launch: placed by its own start
              ("tsar_engine_step#7", 5, 95, 0, 0)]          # a host range drawn on the device row
    return ([(n, False, s * MS, e * MS, c, 0) for n, s, e, c in host]
            + [(n, False, s * MS, e * MS, c, lk) for n, s, e, c, lk in calls]
            + [(n, True, s * MS, e * MS, c, lk) for n, s, e, c, lk in device])


def _close(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(abs(got[k] - want[k]) < 1e-12 for k in want)


def test_device_seconds_follow_the_launch_not_the_clock():
    got = spans.reduce(_events())
    assert got["steps"] == 2 and got["window_s"] == 0.2
    # gemm ran 55-70 ms, while the host sat in tsar.sync, but was launched by
    # aten::mm inside tsar.attn; tsar.attn's own kernels, not its children's.
    assert _close(got["device_s"], {"tsar.proj": 0.010, "tsar.attn": 0.015,
                                    "tsar.kv.write": 0.010, "bench.step": 0.010})
    assert abs(got["unlinked_s"] - 0.010) < 1e-12


def test_device_and_idle_seconds_add_up_to_busy_and_idle():
    events = _events()
    got, base = spans.reduce(events), profile.read([e[:4] for e in events])
    assert abs(got["busy_s"] - base["busy_s"]) < 1e-12 and abs(got["busy_s"] - 0.045) < 1e-12
    assert abs(sum(got["device_s"].values()) - got["busy_s"]) < 1e-12
    assert abs(got["idle_s"] - 0.155) < 1e-12
    assert abs(sum(got["idle_by_span"].values()) - got["idle_s"]) < 1e-12


def test_idle_by_innermost_span_over_each_gap():
    got = spans.reduce(_events())
    # gaps 0-15, 25-55, 80-150, 160-200 ms, cut by the innermost range
    assert _close(got["idle_by_span"], {
        "bench.step": 0.098, "tsar_engine_step": 0.010, "tsar.attn": 0.022,
        "tsar.proj": 0.003, "tsar.kv.write": 0.005, "tsar.sync": 0.015,
        "tsar.sample": 0.002})


def test_launch_calls_counted_in_the_slice():
    events = _events() + [("cudaLaunchKernel", False, 250 * MS, 251 * MS, 1005, 0)]
    assert spans.reduce(events)["launches"] == 3          # the last one is after the slice


def test_segments_cut_a_range_that_outlives_its_parent():
    segs = spans._segments([(0, 10, "a"), (2, 4, "b"), (3, 12, "c")])
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 10, "a")]


def test_nothing_without_spans_a_step_or_the_device():
    events = _events()
    assert spans.reduce([e for e in events if not e[0].startswith("tsar.")]) is None
    assert spans.reduce([e for e in events if e[0] != "bench.step"]) is None
    assert spans.reduce([e for e in events if not e[1]]) is None


def _run(counters, slice_counters=None):
    return SimpleNamespace(slice=None, counters=counters, slice_counters=slice_counters)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_spans_or_counters(name):
    assert spec.reader(name)(_run({"steps": 10, "prefill_s": 1.0, "decode_s": 1.0})) is None


@pytest.mark.parametrize("name, key", [("step_enqueue_ms.chat", "step_enqueue_s"),
                                       ("step_host_ms.chat", "step_host_s")])
def test_step_counters_read_outside_the_slice(name, key):
    run = _run({"steps": 30, key: 1.5}, {"steps": 10, key: 0.9})
    assert abs(spec.reader(name)(run) - 30.0) < 1e-12      # 0.6 s over 20 steps
    assert abs(spec.reader(name)(_run({"steps": 30, key: 1.5})) - 50.0) < 1e-12


def test_device_readers_divide_by_the_slice_steps(monkeypatch):
    got = spans.reduce(_events())
    monkeypatch.setattr(spans, "of", lambda run: got)
    assert abs(spec.reader("attn_ms.chat")(None) - 7.5) < 1e-12     # 15 ms over 2 steps
    assert abs(spec.reader("kv_view_ms.chat")(None) - 5.0) < 1e-12
    assert spec.reader("launches_step.chat")(None) == 1.5


@pytest.mark.parametrize("has_prof", [True, False])
def test_of_reduces_the_profiler_the_run_carries(monkeypatch, has_prof):
    class Run:
        slice = {}
        prof = object() if has_prof else None

    run = Run()
    monkeypatch.setattr(spans, "kineto_events", lambda prof: _events() if prof is run.prof else [])
    got = spans.of(run)
    assert got == (spans.reduce(_events()) if has_prof else None)
    assert spans.of(run) is got                   # once a run


def test_readers_find_the_runs_profiler_and_its_spans(tmp_path, monkeypatch):
    """A traced run of the reduced cell on the CPU: the readers reach the
    slice's profiler through ``Run.prof``, whose events hold the program's
    spans, and reduce them once for the five metrics.  The CPU has no
    device activity, so a stand-in replaces the slice's reduction and the
    spans' result is None; the steps take 10 ms of a virtual clock, so the
    slice of 20 steps fits the window however loaded the CPU is."""
    import torch

    from _benchh100_tiny import tiny_root
    from h100bench import cellrun, loadgen
    from repro_torch.serving import engine as eng

    clock = SimpleNamespace(t=0.0)
    clock.perf_counter = lambda: clock.t
    clock.sleep = lambda s: setattr(clock, "t", clock.t + max(0.0, s))
    monkeypatch.setattr(loadgen, "time", clock)
    monkeypatch.setattr(cellrun, "time", clock)
    step = eng.ServingEngine.step

    def timed_step(self):
        clock.t += 0.01
        return step(self)
    monkeypatch.setattr(eng.ServingEngine, "step", timed_step)
    monkeypatch.setattr(profile, "read", lambda events: {
        "window_s": 0.2, "busy_s": 0.1, "tsar_s": 0.0, "device_ops": [], "idle_gaps": []})
    seen, carried = [], []
    of, kineto_events = spans.of, spans.kineto_events

    def of_run(run):
        carried.append(run.prof)
        return of(run)

    def events_of(prof):
        carried.append(prof)
        return kineto_events(prof)
    monkeypatch.setattr(spans, "of", of_run)
    monkeypatch.setattr(spans, "kineto_events", events_of)

    def reduce(events):
        seen.append({e[0].split("#")[0] for e in events if e[0].startswith(spans.RANGES)})
        return None
    monkeypatch.setattr(spans, "reduce", reduce)
    name = spec.load_benchmark()["workloads"][0]["name"]
    out = cellrun.run(name, 2**31 + 4243, 0.6, True, t_start=0.0, root=tiny_root(tmp_path),
                      device="cpu")
    assert len(seen) == 1
    assert isinstance(carried[0], torch.profiler.profile)
    assert all(p is carried[0] for p in carried)
    assert {"tsar.attn", "tsar.proj", "tsar.kv.write", "tsar.sync", "tsar.emit",
            "tsar_engine_step", "bench.step"} <= seen[0]
    assert not set(READERS[:3]) & set(out["metrics"])
    assert set(READERS[3:]) <= set(out["metrics"])
