"""Timeline analysis over a saved observability trace (a copy of the
reference's ``repro/obs/timeline.py``: the same analysis, text and exit
codes, over either package's files).

``python -m repro_torch.obs.timeline trace.json`` loads + validates a Perfetto
document written by :class:`repro_torch.obs.trace.EventTracer`;
``python -m repro_torch.obs.timeline trace.jsonl`` stream-parses a rotated
``OBS_TRACE_STREAM`` JSONL file (``StreamingSink`` output) one event at a
time — the analysis is single-pass with O(requests + preemptions) state,
so it never materializes a long run's event list.  Both paths summarize
what the raw event stream actually says about the run:

* **step-budget utilization** — Σ realized / Σ planned tokens across step
  records.  ``planned`` is the padded B×C step width (the rows the jitted
  kernel really multiplies), so ``1 - utilization`` is exactly the padding
  waste the ROADMAP's flat token-packing item targets.  A zero-step trace
  reports ``None`` (JSON null) rather than NaN — and fails a
  ``--min-step-utilization`` gate with a clear message instead of a
  silent pass (``nan < x`` is always False) or a traceback.
* **batch occupancy** — mean active slots per step, against the slot count.
* **per-phase time** — wall time split into prefill-carrying vs pure-decode
  steps (from complete-event durations) plus per-request queued/prefill/
  decode span totals.
* **preemption/eviction causality** — for each ``preempted`` mark: the
  nearest preceding ``kv_pressure`` / ``prefix_evict`` instants (why),
  and whether the victim was later re-admitted or never finished (what
  happened next).
* **prefix reuse** — hit marks with cached token counts, insert/evict
  instants grouped by cause.

``--require`` turns the CLI into a CI smoke gate: exit nonzero unless the
trace contains the named features (e.g. a shared-prefix run's
``prefix-hit``).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import trace as _trace

_PRESSURE_NAMES = ("kv_pressure", "prefix_evict")


class _Accumulator:
    """Single-pass analysis state over a trace-event stream.  Relies only
    on stream order (events are appended as they happen; ``ts`` is
    monotone in emission order), so it works identically over an in-memory
    document and a disk-backed JSONL stream."""

    def __init__(self):
        # steps
        self.n_steps = 0
        self.n_prefill_steps = 0
        self.n_decode_steps = 0
        self.planned = 0
        self.realized = 0
        self.occ_sum = 0
        self.occ_n = 0
        self.wall_prefill = 0.0
        self.wall_decode = 0.0
        self.kernels: dict = {}
        # spans
        self._open_ts: dict = {}
        self._span_totals: dict = {}
        self._span_counts: dict = {}
        # requests + preemption causality
        self.req_ids: set = set()
        self._admitted: dict = {}    # uid -> [(ts, readmission), ...]
        self._finished: dict = {}    # uid -> [ts, ...]
        self._last_pressure = None   # most recent pressure instant
        self._preempts: list = []    # (uid, ts, cause-snapshot) in order
        # prefix reuse + instants
        self.hits = 0
        self.hit_tokens = 0
        self.inserts = 0
        self.evict_by_cause: dict = {}
        self.kv_pressure_events = 0

    def feed(self, e: dict):
        ph = e.get("ph")
        name = e.get("name")
        if ph == "X" and name == "step":
            args = e["args"]
            self.n_steps += 1
            self.planned += args.get("planned", 0)
            self.realized += args.get("realized", 0)
            if "active_slots" in args:
                self.occ_sum += args["active_slots"]
                self.occ_n += 1
            if args.get("prefill_tokens", 0) > 0:
                self.n_prefill_steps += 1
                self.wall_prefill += e["dur"]
            else:
                self.n_decode_steps += 1
                self.wall_decode += e["dur"]
            k = args.get("kernel")
            if k is not None:
                self.kernels[k] = self.kernels.get(k, 0) + 1
        elif ph in ("b", "e"):
            if name == "req":
                self.req_ids.add(e["id"])
            key = (e.get("id"), name)
            if ph == "b":
                self._open_ts[key] = e["ts"]
            elif key in self._open_ts:
                self._span_totals[name] = self._span_totals.get(name, 0.0) \
                    + (e["ts"] - self._open_ts.pop(key))
                self._span_counts[name] = self._span_counts.get(name, 0) + 1
        elif ph == "n":
            if name == "req":
                self.req_ids.add(e["id"])
            if name == "admitted":
                self._admitted.setdefault(e["id"], []).append(
                    (e["ts"], bool(e["args"].get("readmission"))))
            elif name == "finished":
                self._finished.setdefault(e["id"], []).append(e["ts"])
            elif name == "preempted":
                p = self._last_pressure
                cause = None
                if p is not None and p["ts"] <= e["ts"]:
                    cause = {"event": p["name"], **p["args"]}
                self._preempts.append((e["id"], e["ts"], cause))
            elif name == "prefix_hit":
                self.hits += 1
                self.hit_tokens += e["args"].get("cached_len", 0)
        elif ph == "i":
            if name in _PRESSURE_NAMES:
                self._last_pressure = e
            if name == "kv_pressure":
                self.kv_pressure_events += 1
            elif name == "prefix_evict":
                c = e["args"].get("cause", "unknown")
                self.evict_by_cause[c] = self.evict_by_cause.get(c, 0) + 1
            elif name == "prefix_insert":
                self.inserts += 1

    def summary(self) -> dict:
        chains = []
        for uid, ts, cause in self._preempts:
            readmit = any(a_ts > ts and re_adm
                          for a_ts, re_adm in self._admitted.get(uid, ()))
            finished = any(f > ts for f in self._finished.get(uid, ()))
            chains.append({"uid": uid, "cause": cause,
                           "readmitted": readmit, "finished": finished})
        spans = {name: {"total_us": self._span_totals[name],
                        "n": self._span_counts[name]}
                 for name in self._span_totals}
        return {
            "n_requests": len(self.req_ids),
            "steps": {
                "n": self.n_steps,
                "prefill": self.n_prefill_steps,
                "decode": self.n_decode_steps,
                "planned_tokens": self.planned,
                "realized_tokens": self.realized,
                # None (JSON null), not NaN: a zero-step trace must be
                # distinguishable in strict JSON and must not silently
                # pass a numeric gate.
                "budget_utilization": (self.realized / self.planned)
                                      if self.planned else None,
                "mean_active_slots": (self.occ_sum / self.occ_n)
                                     if self.occ_n else None,
                "wall_us": {
                    "prefill": self.wall_prefill,
                    "decode": self.wall_decode,
                },
                "kernel_steps": self.kernels,
            },
            "spans_us": spans,
            "preemptions": {
                "n": len(chains),
                "readmitted": sum(c["readmitted"] for c in chains),
                "chains": chains,
            },
            "prefix": {
                "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "inserts": self.inserts,
                "evictions_by_cause": self.evict_by_cause,
            },
            "kv_pressure_events": self.kv_pressure_events,
        }


def analyze_events(events) -> dict:
    """Pure single-pass analysis over an event iterable (document list or
    stream reader) — everything but the provenance fields."""
    acc = _Accumulator()
    for e in events:
        acc.feed(e)
    return acc.summary()


def analyze(doc: dict) -> dict:
    """Perfetto document -> summary dict (JSON-safe)."""
    evs = doc["traceEvents"]
    out = analyze_events(evs)
    out["schema_version"] = doc["otherData"]["schema_version"]
    out["fingerprint"] = doc["otherData"]["fingerprint"]
    out["n_events"] = len(evs)
    return out


def analyze_stream(reader) -> dict:
    """JSONL stream (path or :class:`repro_torch.obs.trace.StreamReader`) ->
    the same summary :func:`analyze` produces for the equivalent document,
    plus a ``stream`` provenance block — without ever holding the event
    list in memory."""
    if isinstance(reader, str):
        reader = _trace.StreamReader(reader)
    out = analyze_events(iter(reader))
    out["schema_version"] = reader.header["schema_version"]
    out["fingerprint"] = reader.fingerprint
    out["n_events"] = reader.n_events
    out["stream"] = {"complete": reader.complete,
                     "segments": (reader.footer or {}).get("segments")}
    return out


def _pct(x) -> str:
    return "n/a" if x is None or x != x else f"{100.0 * x:.1f}%"


def format_summary(s: dict) -> str:
    st = s["steps"]
    lines = [
        f"trace: {s['n_events']} events, {s['n_requests']} requests, "
        f"schema v{s['schema_version']}",
        f"  fingerprint: {s['fingerprint'][:23]}...",
        f"steps: {st['n']} ({st['prefill']} prefill-carrying, "
        f"{st['decode']} pure-decode)",
        f"  step-budget utilization: {_pct(st['budget_utilization'])} "
        f"({st['realized_tokens']}/{st['planned_tokens']} tokens; "
        f"rest is padded batch width)",
        f"  mean active slots: {st['mean_active_slots']:.2f}"
        if st["mean_active_slots"] is not None
        else "  mean active slots: n/a",
        f"  wall time: prefill {st['wall_us']['prefill'] / 1e3:.1f} ms, "
        f"decode {st['wall_us']['decode'] / 1e3:.1f} ms",
    ]
    if s.get("stream"):
        state = "complete" if s["stream"]["complete"] else \
            "INCOMPLETE (no final footer — writer died mid-run?)"
        lines.insert(1, f"  stream: {state}, "
                        f"{s['stream'].get('segments') or '?'} segment(s)")
    if st["kernel_steps"]:
        ks = ", ".join(f"{k}: {v}" for k, v in
                       sorted(st["kernel_steps"].items()))
        lines.append(f"  steps by plan kernel: {ks}")
    if s["spans_us"]:
        lines.append("request phases (total across requests):")
        for name in ("queued", "prefill", "decode"):
            if name in s["spans_us"]:
                d = s["spans_us"][name]
                lines.append(f"  {name:8s} {d['total_us'] / 1e3:9.1f} ms "
                             f"across {d['n']} spans")
    pre = s["preemptions"]
    lines.append(f"preemptions: {pre['n']} "
                 f"({pre['readmitted']} later re-admitted); "
                 f"kv-pressure events: {s['kv_pressure_events']}")
    for c in pre["chains"]:
        cause = "no prior pressure event" if c["cause"] is None else \
            ", ".join(f"{k}={v}" for k, v in c["cause"].items())
        fate = "finished" if c["finished"] else "unfinished"
        re = "re-admitted" if c["readmitted"] else "not re-admitted"
        lines.append(f"  req {c['uid']}: cause [{cause}] -> {re}, {fate}")
    px = s["prefix"]
    ev = ", ".join(f"{k}: {v}" for k, v in
                   sorted(px["evictions_by_cause"].items())) or "none"
    lines.append(f"prefix cache: {px['hits']} hits "
                 f"({px['hit_tokens']} cached tokens), "
                 f"{px['inserts']} inserts, evictions by cause: {ev}")
    return "\n".join(lines)


_REQUIRE_CHECKS = {
    "prefill-span": lambda s: s["spans_us"].get("prefill", {}).get("n", 0) > 0,
    "decode-span": lambda s: s["spans_us"].get("decode", {}).get("n", 0) > 0,
    "prefix-hit": lambda s: s["prefix"]["hits"] > 0,
    "preemption": lambda s: s["preemptions"]["n"] > 0,
    "step": lambda s: s["steps"]["n"] > 0,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.timeline",
        description="Summarize an engine observability trace "
                    "(Perfetto trace_event JSON document, or a "
                    "StreamingSink JSONL stream).")
    ap.add_argument("trace", help="path to a --trace-out JSON document or "
                                  "a --trace-stream JSONL stream")
    ap.add_argument("--json", action="store_true",
                    help="emit the analysis as JSON instead of text")
    ap.add_argument("--require", nargs="+", choices=sorted(_REQUIRE_CHECKS),
                    default=(), metavar="FEATURE",
                    help="exit 1 unless the trace contains these features "
                         f"(choices: {', '.join(sorted(_REQUIRE_CHECKS))})")
    ap.add_argument("--min-step-utilization", type=float, default=None,
                    metavar="FRACTION",
                    help="exit 1 unless step-budget utilization "
                         "(realized/planned over all steps) is >= FRACTION "
                         "— the CI gate keeping the flat token layout's "
                         "padding-waste win from regressing")
    args = ap.parse_args(argv)

    kind, obj = _trace.load_any(args.trace)
    summary = analyze_stream(obj) if kind == "stream" else analyze(obj)

    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(format_summary(summary))

    missing = [r for r in args.require if not _REQUIRE_CHECKS[r](summary)]
    if missing:
        print(f"MISSING required trace features: {', '.join(missing)}",
              file=sys.stderr)
        return 1
    if args.min_step_utilization is not None:
        util = summary["steps"]["budget_utilization"]
        if util is None:
            print("trace contains no step records (planned tokens == 0): "
                  "cannot evaluate --min-step-utilization "
                  f"{args.min_step_utilization}", file=sys.stderr)
            return 1
        if util < args.min_step_utilization:
            print(f"step-budget utilization {util} below required "
                  f"{args.min_step_utilization}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
