"""The ``torch.profiler`` slice of a traced run and what is read from it.

A traced run profiles a bounded run of steady steps inside its window (the
cell file's ``trace.steps``, starting ``trace.offset`` of the way into the
window): CPU and CUDA activity, the load generator's ranges (``bench.step``
around ``engine.step()``, ``bench.stamp``, ``bench.submit``, ``bench.idle``)
and the engine's ``tsar_engine_step#<n>`` ranges.  The slice is read after
the drain, so reading it costs the window nothing.  Its span is the first
``bench.step`` range's start to the last one's end; the device is busy
where any device activity (kernel, copy, set) runs, idle elsewhere.
Kernels of the port's ternary projections are named ``tsar_*``.
"""
from __future__ import annotations

import bisect
import re

# A kernel of the port's projections: its function's own name (after any
# ``void``, namespace and class qualifiers, before its template arguments)
# starts with ``tsar_``; the port's kernels live in anonymous namespaces.
TSAR = re.compile(r"^(void )?([\w()\s]+::)*tsar_\w*[<(]?")
# The load generator's and the engine's host ranges.
RANGES = ("bench.", "tsar_engine_step")
TOP = 10
# Idle gaps labelled, the longest first (the rest are summed unlabelled),
# and the host ops opened before a gap that are searched for its label.
GAPS = 250000
BACK = 64


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label(name: str) -> str:
    return re.sub(r"#\d+$", "", name)


def read(events) -> dict | None:
    """Reduce kineto events ``(name, is_device, start_ns, end_ns)`` of one
    slice: span, busy seconds, device seconds by kernel name, ``tsar_*``
    seconds, and idle seconds by the innermost host range open at each
    gap's start, summed by label (the labels' seconds add up to the idle
    time).  None without a ``bench.step`` range or device activity."""
    host, dev = [], []
    for name, is_device, s, e in events:
        if is_device and name.startswith(RANGES):
            continue                    # a host range drawn on the device's timeline
        (dev if is_device else host).append((name, s, e))
    steps = [(s, e) for name, s, e in host if name == "bench.step"]
    if not steps or not dev:
        return None
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    busy = _union([(s, e) for _, s, e in dev])
    by_name: dict[str, float] = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    host.sort(key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    # Ranges that stay open across many ops; every other candidate is among
    # the last ops opened before the gap.
    long = [h for h in host if h[0].startswith(RANGES)]
    idle: dict[str, float] = {}
    for k, (gs, ge) in enumerate(sorted(gaps, key=lambda g: g[0] - g[1])):
        label = "shorter gaps (not labelled)"
        if k < GAPS:
            i = bisect.bisect_right(starts, gs)
            open_ = [(e - s, n) for n, s, e in host[max(0, i - BACK):i] + long
                     if s <= gs < e and n != "bench.step"]
            label = _label(min(open_)[1]) if open_ else "host outside every range"
        idle[label] = idle.get(label, 0.0) + (ge - gs) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "tsar_s": sum(v for n, v in by_name.items() if TSAR.match(n)),
        "device_ops": [[n[:160], v] for n, v in top],
        "idle_gaps": [[n[:160], v] for n, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    }


def kineto_events(prof) -> list:
    """``(name, is_device, start_ns, end_ns)`` of a stopped
    ``torch.profiler.profile``.  The device's copies of host ranges (user
    annotations drawn on the GPU timeline) are not device activity and are
    left out."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        on_device = ev.device_type() != DeviceType.CPU
        if on_device and ev.is_user_annotation():
            continue
        out.append((ev.name(), on_device, ev.start_ns(), ev.end_ns()))
    return out
