"""The program's spans in the profiled slice: device and idle seconds by
the layer of the port that was running, and the launch calls.

Inside a step the port opens ``torch.profiler`` ranges named ``tsar.<layer>``
(``repro_torch.obs.trace.span``) around its layers: the attention, the
projections, the KV view's gather, scatter, writes and stack, the sync, and
the engine's host work (admit, plan, upload, sample, emit); the model call
is ``tsar_engine_step#<n>``, the load generator's ranges ``bench.*``
(``h100bench.profile``).  From the slice's kineto events this module gives

* device seconds by the innermost range open at each kernel's launch: a
  kernel is tied to its launch by correlation id (its
  ``linked_correlation_id`` is the host op open at the launch; failing
  that, its ``correlation_id`` is its launch call's), so its attribution
  does not depend on the device clock, which drifts against the host's;
  where kernels overlap, each instant of busy time goes to the kernel that
  began first, so the seconds add up to the busy time;
* idle seconds by the innermost range open at each instant of each idle
  gap, found by interval stabbing over every range of the slice; they add
  up to the idle time;
* the launch calls (``LAUNCHES``) that start in the slice.

The slice and its busy time are ``h100bench.profile.read``'s.  Nothing is
read without a ``tsar.`` range: a program without spans gives None.
"""
from __future__ import annotations

import bisect
import json
import sys
import weakref

from h100bench import profile

SPAN = "tsar."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
RANGES = profile.RANGES + (SPAN,)
OUTSIDE = "host outside every range"


def kineto_events(prof) -> list:
    """``(name, is_device, start_ns, end_ns, correlation_id,
    linked_correlation_id)`` of a stopped ``torch.profiler.profile``,
    without the device's copies of host ranges."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        on_device = ev.device_type() != DeviceType.CPU
        if on_device and ev.is_user_annotation():
            continue
        out.append((ev.name(), on_device, ev.start_ns(), ev.end_ns(), ev.correlation_id(),
                    ev.linked_correlation_id()))
    return out


def _label(name: str) -> str:
    return name.split("#", 1)[0]


def _segments(ranges: list) -> list:
    """``(start, end, label)`` pieces of the host timeline, each under one
    innermost range, from ``(start, end, label)`` ranges that nest (a
    range that outlives its parent is cut at the parent's end)."""
    segs, stack, t = [], [], None

    def close_to(end):
        nonlocal t
        if end > t:
            segs.append((t, end, stack[-1][1]))
            t = end

    for s, e, label in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            close_to(stack[-1][0])
            stack.pop()
        if stack:
            close_to(s)
            e = min(e, stack[-1][0])
        stack.append((e, label))
        t = s
    while stack:
        close_to(stack[-1][0])
        stack.pop()
    return segs


def _innermost(segs: list, starts: list, t: int) -> str:
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE


def reduce(events) -> dict | None:
    """Reduce ``kineto_events`` of one slice: its ``steps`` (``bench.step``
    ranges), ``window_s``, ``busy_s``, ``idle_s``, ``device_s`` and
    ``idle_by_span`` (seconds by label: a ``tsar.*`` span, the bare
    ``tsar_engine_step``, a ``bench.*`` range or ``OUTSIDE``), ``launches``
    and ``unlinked_s`` (device seconds of kernels tied to no launch, placed
    by their own start).  None without a ``bench.step`` range, device
    activity or a ``tsar.`` span."""
    ranges, ops, calls, launches, dev = [], {}, {}, [], []
    for name, is_device, s, e, corr, linked in events:
        if is_device:
            if not name.startswith(RANGES):
                dev.append((s, e, corr, linked))
            continue
        if name.startswith(RANGES):
            ranges.append((s, e, _label(name)))
        if name.startswith("cu"):
            calls[corr] = s
            if name in LAUNCHES:
                launches.append(s)
        else:
            ops[corr] = s
    steps = [(s, e) for s, e, label in ranges if label == "bench.step"]
    if not steps or not dev or not any(label.startswith(SPAN) for _, _, label in ranges):
        return None
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    segs = _segments(ranges)
    starts = [s for s, _, _ in segs]

    device: dict[str, int] = {}
    unlinked, at = 0, lo
    for s, e, corr, linked in sorted(dev):
        t = ops.get(linked) if linked else None
        if t is None:
            t = calls.get(corr)
        s, e = max(s, at), min(e, hi)
        if e <= s:
            continue
        label = _innermost(segs, starts, s if t is None else t)
        device[label] = device.get(label, 0) + e - s
        if t is None:
            unlinked += e - s
        at = e

    busy = profile._union([(max(s, lo), min(e, hi)) for s, e, _, _ in dev if e > lo and s < hi])
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    idle: dict[str, int] = {}
    for gs, ge in gaps:
        left = ge - gs
        i = max(0, bisect.bisect_right(starts, gs) - 1)
        while i < len(segs) and segs[i][0] < ge:
            part = min(ge, segs[i][1]) - max(gs, segs[i][0])
            if part > 0:
                idle[segs[i][2]] = idle.get(segs[i][2], 0) + part
                left -= part
            i += 1
        if left:
            idle[OUTSIDE] = idle.get(OUTSIDE, 0) + left
    busy_ns = sum(e - s for s, e in busy)
    return {
        "steps": len(steps),
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "idle_s": (hi - lo - busy_ns) * 1e-9,
        "device_s": {k: v * 1e-9 for k, v in sorted(device.items(), key=lambda kv: -kv[1])},
        "idle_by_span": {k: v * 1e-9 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "launches": sum(lo <= s <= hi for s in launches),
        "unlinked_s": unlinked * 1e-9,
    }


_last: tuple = (None, None)      # (weak reference to a Run, its reduction)


def of(run) -> dict | None:
    """``reduce`` of ``run``'s profiled slice, computed once a run (the
    readers of several metrics share it) and logged to standard error;
    None without a slice, a profiler or spans."""
    global _last
    if run.slice is None:
        return None
    ref, got = _last
    if ref is not None and ref() is run:
        return got
    got = None if run.prof is None else reduce(kineto_events(run.prof))
    if got is not None:
        print("spans: " + json.dumps(got), file=sys.stderr, flush=True)
    _last = (weakref.ref(run), got)
    return got
