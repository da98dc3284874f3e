"""Trace replay against the port's serving engine (port of
``benchmarks/workloads/runner.py``: ``build_engine``, ``replay`` and
``run_workload``).

``replay`` drives a :class:`~repro_torch.serving.ServingEngine` step by step
in **virtual time**: one engine step advances the clock by ``step_dt``
units, and every trace request whose arrival time has passed is submitted
before the next step.  The scheduling structure (who queues behind whom,
when admission happens relative to running decodes) is therefore a pure
function of the trace: wall-clock enters only through the measured
latencies, so two runs of the same trace are structurally identical and
their deterministic counters (preemptions, scheduled prefill tokens, hit
rates) match exactly, as they match the reference engine's.

The reference's suite (``run_suite``, ``measure_slo_scale``, the CSV
rows and the ``BENCH_e2e.json`` schema) is not here: it belongs to the
port's benchmark.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.serving import Request, ServingEngine
from repro_torch.workloads import metrics
from repro_torch.workloads.generator import WorkloadSpec, generate
from repro_torch.workloads.trace import Trace


def build_engine(spec: WorkloadSpec, cfg, params, *, packed: bool = True,
                 policy: str | None = None, prefix_cache=None, tracer=None,
                 incidents=None, device="cuda", **kw) -> ServingEngine:
    """A ServingEngine on ``device`` from a workload spec's engine hints.
    ``prefix_cache`` overrides the spec hint (the cache-off control
    replay); ``tracer`` attaches an ``obs.trace.EventTracer``, ``incidents``
    an ``obs.incident.IncidentMonitor``; ``kw`` passes further engine
    options (``profiler_annotations``, ...)."""
    e = spec.engine
    if prefix_cache is None:
        prefix_cache = e.get("prefix_cache", False)
    return ServingEngine(
        cfg, params,
        max_len=e.get("max_len", 128),
        batch_slots=e.get("slots", 4),
        packed=packed,
        prefill_chunk=e.get("prefill_chunk", 16),
        block_size=e.get("block_size", 16),
        kv_blocks=e.get("kv_blocks"),
        policy=policy,
        prefix_cache=prefix_cache,
        tracer=tracer,
        incidents=incidents,
        device=device, **kw)


def replay(engine, trace: Trace, *, step_dt: float = 1.0,
           warmup: bool = True) -> tuple[list, float]:
    """Replay ``trace`` through ``engine``; returns (requests, wall_s).

    Requests are returned in trace (uid) order with latency stamps filled.
    ``warmup`` first serves a throwaway request as long as the trace's
    longest (and resets the counters), so the percentiles measure
    steady-state serving; pass False to measure a cold start.  Raises
    ``RuntimeError`` when an idle engine cannot admit the head of its queue
    (the spec's ``kv_blocks`` / ``max_len`` hints cannot hold a request).
    """
    order = sorted(trace.requests, key=lambda t: (t.arrival, t.uid))
    by_uid = {}
    reqs = []
    for t in order:
        r = Request(uid=t.uid, prompt=np.asarray(t.prompt, np.int32),
                    max_new_tokens=t.max_new_tokens,
                    temperature=t.temperature)
        reqs.append(r)
        by_uid[t.uid] = r
    if warmup:
        longest = max((len(t.prompt) + t.max_new_tokens for t in order),
                      default=0)
        engine.warmup(seq_len=longest)

    vt, i, n = 0.0, 0, len(reqs)
    t0 = time.perf_counter()
    while i < n or engine.busy:
        while i < n and order[i].arrival <= vt + 1e-9:
            engine.submit(reqs[i])
            i += 1
        if not engine.step():
            if engine.queue_len:
                # As ServingEngine.run(): the pool can never cover the
                # head-of-queue request, a workload/engine config error.
                raise RuntimeError(
                    f"trace {trace.name!r}: request cannot be admitted on an "
                    "idle engine; check the spec's kv_blocks/max_len hints")
            if i < n:
                vt = max(vt, order[i].arrival)   # idle gap: jump to arrival
                continue
        vt += step_dt
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    return [by_uid[t.uid] for t in trace.requests], wall


def run_workload(spec: WorkloadSpec, cfg, params, *, packed: bool = True,
                 policy: str | None = None, prefix_cache=None,
                 warmup: bool = True, trace: Trace | None = None,
                 tracer=None, slo_scale: float = 1.0, incidents=None,
                 device="cuda"):
    """Generate (or take) the trace, replay it, and return
    ``(report_block, engine, requests)``; the block holds the spec, the
    trace's fingerprint, :func:`metrics.latency_metrics` and
    :func:`metrics.engine_counters`, under the reference's keys."""
    trace = generate(spec) if trace is None else trace
    engine = build_engine(spec, cfg, params, packed=packed, policy=policy,
                          prefix_cache=prefix_cache, tracer=tracer,
                          incidents=incidents, device=device)
    reqs, wall = replay(engine, trace, warmup=warmup)
    block = {
        "spec": spec.to_dict(),
        "trace_fingerprint": trace.fingerprint(),
        "metrics": metrics.latency_metrics(reqs, trace, wall, slo_scale),
        "counters": metrics.engine_counters(engine),
    }
    return block, engine, reqs
