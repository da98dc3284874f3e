"""Percentile latency metrics, goodput under per-request SLOs, and the
engine's deterministic counters (port of ``benchmarks/workloads/metrics.py``,
the same keys).

Every latency is reported as {p50, p90, p99, mean, max} over finished
requests, and goodput is the fraction (and rate) of requests that met
*their own* SLOs:

* **TTFT** — time to first token (queueing + prefill), ``Request.ttft``;
* **TPOT** — mean time per output token after the first, ``Request.tpot``;
* **queue** — submit -> first admission into a slot, ``Request.queue_s``;
* **good request** — every SLO the trace set for it is met
  (``ttft <= slo_ttft_s * slo_scale`` and ``tpot <= slo_tpot_s * slo_scale``;
  an unset axis always passes; a request that produced no tokens is never
  good).

``slo_scale`` scales every threshold (the reference's ``run_suite`` derives
it from a measured decode step; the presets' values assume
:data:`NOMINAL_DECODE_STEP_S`).

Counters are the deterministic side of a run: given the same trace and
code, steps, preemptions, scheduled prefill tokens and cache hit rates do
not depend on the machine, nor on the model's width: the scheduler sees
lengths and the spec's engine hints only.  ``plan_kernel`` is the compiled
plan's decode kernel, which the port picks with H100 constants.
"""
from __future__ import annotations

import numpy as np

PERCENTILES = (50, 90, 99)

# Reference decode-step latency the preset SLO thresholds assume (seconds
# per pure-decode engine step of the calibration engine — reduced
# bitnet-2b-4t, 2 slots — measured on the machine the thresholds were
# tuned on, a CPU running the JAX package).  The reference's
# ``runner.measure_slo_scale`` divides a fresh measurement by this to get a
# run's ``slo_scale``; the port's replays use a scale of 1.0.
NOMINAL_DECODE_STEP_S = 0.12


def percentile_summary(values) -> dict:
    """{p50, p90, p99, mean, max, n} over ``values`` (NaNs for empty)."""
    xs = np.asarray([v for v in values if v is not None], float)
    if xs.size == 0:
        return {**{f"p{p}": float("nan") for p in PERCENTILES},
                "mean": float("nan"), "max": float("nan"), "n": 0}
    out = {f"p{p}": float(np.percentile(xs, p)) for p in PERCENTILES}
    out["mean"] = float(xs.mean())
    out["max"] = float(xs.max())
    out["n"] = int(xs.size)
    return out


def is_good(req, tr, slo_scale: float = 1.0) -> bool:
    """Did engine-request ``req`` meet trace-request ``tr``'s SLOs, with
    thresholds scaled by the machine calibration factor?"""
    if not req.out_tokens:
        return False
    if tr.slo_ttft_s is not None:
        if req.ttft is None or req.ttft > tr.slo_ttft_s * slo_scale:
            return False
    if tr.slo_tpot_s is not None and req.tpot is not None:
        if req.tpot > tr.slo_tpot_s * slo_scale:
            return False
    return True


def goodput(requests, trace, wall_s: float, slo_scale: float = 1.0) -> dict:
    """Requests meeting their SLOs: fraction, count, and rate per wall
    second.  ``requests`` are engine Requests ordered like
    ``trace.requests`` (the replayer guarantees uid alignment)."""
    by_uid = {tr.uid: tr for tr in trace.requests}
    good = sum(1 for r in requests if is_good(r, by_uid[r.uid], slo_scale))
    total = len(requests)
    return {
        "slo_attained": good / total if total else float("nan"),
        "good": int(good),
        "total": int(total),
        "good_per_s": good / wall_s if wall_s > 0 else float("nan"),
    }


def latency_metrics(requests, trace, wall_s: float,
                    slo_scale: float = 1.0) -> dict:
    """The full per-workload metrics block of a BENCH_e2e report."""
    done = [r for r in requests if r.out_tokens]
    total_out = sum(len(r.out_tokens) for r in done)
    return {
        "ttft_s": percentile_summary(r.ttft for r in done),
        "tpot_s": percentile_summary(r.tpot for r in done),
        "queue_s": percentile_summary(r.queue_s for r in done),
        "goodput": goodput(requests, trace, wall_s, slo_scale),
        "output_tok_s": total_out / wall_s if wall_s > 0 else float("nan"),
        "wall_s": float(wall_s),
    }


def engine_counters(engine) -> dict:
    """Deterministic scheduler/engine counters for the report (exact-gated
    by the comparator — see module docstring)."""
    s = engine.stats
    out = {
        "steps": int(s["steps"]),
        "preemptions": int(s["preemptions"]),
        "preempt_readmissions": int(engine.sched.readmissions),
        "prefill_tokens": int(s["prefill_tokens"]),
        "prefill_tokens_planned": int(engine.sched.prefill_tokens_planned),
        "cached_tokens_skipped": int(engine.sched.cached_tokens_skipped),
        "decode_tokens": int(s["decode_tokens"]),
        "total_tokens": int(s["total_tokens"]),
        "max_step_tokens": int(s["max_step_tokens"]),
        "peak_kv_blocks": int(s["peak_kv_blocks"]),
        "whole_prefills": int(s["whole_prefills"]),
    }
    # Registry-only step accounting (no legacy stats key): planned is the
    # static step width the jitted call multiplies (flat: T; rectangular:
    # the padded B*C), so realized/planned is the padding-waste signal the
    # flat token layout moved.  ``rejections`` keeps goodput denominators
    # honest: prompt-too-long requests are finished-ignored at admission
    # and would otherwise be metric-invisible.
    reg = engine.metrics
    for k in ("planned_tokens", "realized_tokens", "prefill_steps",
              "decode_steps", "admissions", "rejections"):
        out[k] = int(reg.get(k).value)
    if "prefix_hit_rate" in s:
        out["prefix_hit_rate"] = round(float(s["prefix_hit_rate"]), 6)
        out["prefix_hit_tokens"] = int(s["prefix_hit_tokens"])
        out["prefix_evictions"] = int(s["prefix_evictions"])
        out["cached_blocks"] = int(s["cached_blocks"])
    # The decode-bucket kernel the compiled plan committed to (CI asserts
    # this column exists so the plan path can't fall out of the benchmark).
    out["plan_kernel"] = (engine.plan.dominant_kernel(engine.slots)
                          if engine.plan is not None else "none")
    return out
