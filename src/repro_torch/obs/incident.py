"""Incident snapshots: when the engine hits a bad moment, dump the flight
recorder + a metrics snapshot into a schema-versioned file (kind
``OBS_INCIDENT``, schema v1; a copy of the reference's
``repro/obs/incident.py``, whose files each package reads).

The always-on story: run the engine with a :class:`~repro_torch.obs.trace.RingSink`
tracer (cheap, fixed memory) and an :class:`IncidentMonitor` bound to the
engine's registry.  When a trigger fires — an SLO breach, a preemption, an
admission rejection, KV allocator pressure, or an eviction storm — the
monitor writes ``<prefix>-<seq>-<trigger>-<stamp>.json`` into its output
directory containing:

* ``trigger`` + ``context`` — what fired and its site-specific details
  (uid, measured latency vs threshold, eviction counts, ...);
* ``metrics`` — ``MetricsRegistry.snapshot()`` at dump time;
* ``ring`` — the last events out of the tracer's sink (``recent()``),
  i.e. what the engine was doing leading up to the incident;
* provenance — schema version, git revision, engine step, sequence
  number, wall-clock stamp.

Debouncing keeps the always-on path from writing a file per decode token:
a per-trigger **cooldown** (engine steps), a global **max_incidents** cap
(suppressed firings are counted, not silently lost), and a sliding-window
eviction-storm detector (``eviction_storm_n`` evictions within
``eviction_window_steps`` steps) instead of per-eviction dumps.

The monitor deliberately owns no metrics in the engine's registry and the
engine's hook sites sit outside the ``tracer.enabled`` guards: incidents
fire with tracing on or off, and attaching a monitor cannot perturb the
deterministic counters the workload baseline gates exactly (tested).

``ServingEngine.reset_run_stats()`` calls :meth:`IncidentMonitor.reset_run`,
which discards incident files written so far (they came from warm-up) and
re-arms — the same warm-up contract the tracer and registry follow.
"""
from __future__ import annotations

import collections
import json
import os
import time

INCIDENT_KIND = "OBS_INCIDENT"
INCIDENT_SCHEMA_VERSION = 1

TRIGGERS = ("slo_breach", "preemption", "rejection", "kv_pressure",
            "eviction_storm")

_REQUIRED_KEYS = ("kind", "schema_version", "trigger", "context", "seq",
                  "step", "created_unix", "git_rev", "metrics", "ring")


class IncidentMonitor:
    """Trigger-driven incident snapshot writer (see module docstring).

    Bind to an engine implicitly (``ServingEngine(incidents=monitor)``
    calls :meth:`bind`) or explicitly for standalone use.  ``clock`` is
    injectable for deterministic tests; it only stamps files, never enters
    trigger decisions.
    """

    def __init__(self, out_dir: str, *, triggers: tuple = TRIGGERS,
                 prefix: str = "incident",
                 slo_ttft_s: float | None = None,
                 slo_tpot_s: float | None = None,
                 eviction_storm_n: int = 8, eviction_window_steps: int = 16,
                 cooldown_steps: int = 32, max_incidents: int = 16,
                 ring_limit: int = 512, clock=time.time,
                 rev: str | None = None):
        unknown = set(triggers) - set(TRIGGERS)
        if unknown:
            raise ValueError(f"unknown incident triggers {sorted(unknown)}; "
                             f"known: {TRIGGERS}")
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.triggers = tuple(triggers)
        self.prefix = prefix
        self.slo_ttft_s = slo_ttft_s
        self.slo_tpot_s = slo_tpot_s
        self.eviction_storm_n = int(eviction_storm_n)
        self.eviction_window_steps = int(eviction_window_steps)
        self.cooldown_steps = int(cooldown_steps)
        self.max_incidents = int(max_incidents)
        self.ring_limit = int(ring_limit)
        self._clock = clock
        self._rev = rev
        self.paths: list = []
        self.fired: dict = {}       # trigger -> count actually dumped
        self.suppressed = 0         # firings debounced/capped away
        self._seq = 0
        self._step = 0
        self._last_fire: dict = {}  # trigger -> step of last dump
        self._evict_window: collections.deque = collections.deque()
        self._registry = None
        self._tracer = None

    def bind(self, *, registry=None, tracer=None):
        """Attach the metrics registry and tracer whose state dumps
        capture.  Either may be None (sections come out empty)."""
        if registry is not None:
            self._registry = registry
        if tracer is not None:
            self._tracer = tracer
        return self

    # -- engine hook surface -------------------------------------------------

    def step_tick(self, *, evictions: int = 0):
        """Called once per engine step.  Advances the debounce clock and
        feeds the sliding-window eviction-storm detector."""
        self._step += 1
        if evictions > 0:
            self._evict_window.append((self._step, int(evictions)))
        horizon = self._step - self.eviction_window_steps
        while self._evict_window and self._evict_window[0][0] <= horizon:
            self._evict_window.popleft()
        total = sum(n for _, n in self._evict_window)
        if total >= self.eviction_storm_n:
            if self.observe("eviction_storm", evictions=total,
                            window_steps=self.eviction_window_steps):
                self._evict_window.clear()

    def request_first_token(self, req):
        """TTFT SLO check at first-token emission."""
        t = getattr(req, "ttft", None)
        if self.slo_ttft_s is not None and t is not None \
                and t > self.slo_ttft_s:
            self.observe("slo_breach", kind="ttft", uid=req.uid,
                         measured_s=float(t), threshold_s=self.slo_ttft_s)

    def request_finished(self, req):
        """TPOT SLO check at request completion."""
        t = getattr(req, "tpot", None)
        if self.slo_tpot_s is not None and t is not None \
                and t > self.slo_tpot_s:
            self.observe("slo_breach", kind="tpot", uid=req.uid,
                         measured_s=float(t), threshold_s=self.slo_tpot_s)

    # -- trigger + dump ------------------------------------------------------

    def observe(self, trigger: str, **context):
        """Report a trigger firing.  Returns the incident file path when a
        dump was written, else None (trigger unconfigured, in cooldown, or
        over the cap)."""
        if trigger not in self.triggers:
            return None
        if self._seq >= self.max_incidents:
            self.suppressed += 1
            return None
        last = self._last_fire.get(trigger)
        if last is not None and self._step - last < self.cooldown_steps:
            self.suppressed += 1
            return None
        self._last_fire[trigger] = self._step
        return self._dump(trigger, context)

    def _dump(self, trigger: str, context: dict) -> str:
        from repro_torch.obs import trace as _trace
        sink = getattr(self._tracer, "sink", None)
        ring = sink.recent(self.ring_limit) if hasattr(sink, "recent") else []
        now = float(self._clock())
        doc = {
            "kind": INCIDENT_KIND,
            "schema_version": INCIDENT_SCHEMA_VERSION,
            "trigger": trigger,
            "context": context,
            "seq": self._seq,
            "step": self._step,
            "created_unix": now,
            "git_rev": _trace.git_rev() if self._rev is None else self._rev,
            "metrics": (self._registry.snapshot()
                        if self._registry is not None else {}),
            "ring": {
                "n_events": len(ring),
                "n_dropped": getattr(sink, "n_dropped", 0),
                "events": ring,
            },
        }
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        path = os.path.join(
            self.out_dir, f"{self.prefix}-{self._seq:03d}-{trigger}-{stamp}.json")
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        self.paths.append(path)
        self.fired[trigger] = self.fired.get(trigger, 0) + 1
        self._seq += 1
        return path

    def reset_run(self, *, discard: bool = True):
        """Warm-up reset: re-arm all debouncing and (by default) delete the
        incident files written so far — they describe warm-up, not the
        run.  Only files this monitor itself wrote are touched."""
        if discard:
            for p in self.paths:
                try:
                    os.remove(p)
                except OSError:
                    pass
        self.paths = []
        self.fired = {}
        self.suppressed = 0
        self._seq = 0
        self._step = 0
        self._last_fire = {}
        self._evict_window.clear()

    def summary(self) -> dict:
        """Provenance block for reports: counts + file paths."""
        return {"n": len(self.paths), "by_trigger": dict(self.fired),
                "suppressed": self.suppressed, "paths": list(self.paths)}


# ---------------------------------------------------------------------------
# incident document IO/validation
# ---------------------------------------------------------------------------

def _fail(path: str, msg: str):
    raise ValueError(f"{INCIDENT_KIND} schema: {path}: {msg}")


def validate_incident(doc: dict) -> dict:
    """Structural validation; returns ``doc``."""
    if not isinstance(doc, dict):
        _fail("$", "expected object")
    for k in _REQUIRED_KEYS:
        if k not in doc:
            _fail("$", f"missing key {k!r}")
    if doc["kind"] != INCIDENT_KIND:
        _fail("$.kind", f"{doc['kind']!r} != {INCIDENT_KIND!r}")
    if doc["schema_version"] != INCIDENT_SCHEMA_VERSION:
        _fail("$.schema_version",
              f"{doc['schema_version']!r} != {INCIDENT_SCHEMA_VERSION}")
    if doc["trigger"] not in TRIGGERS:
        _fail("$.trigger", f"unknown trigger {doc['trigger']!r}")
    if not isinstance(doc["context"], dict):
        _fail("$.context", "expected object")
    if not isinstance(doc["metrics"], dict):
        _fail("$.metrics", "expected object")
    ring = doc["ring"]
    if not isinstance(ring, dict) or "events" not in ring:
        _fail("$.ring", "expected object with events")
    if not isinstance(ring["events"], list):
        _fail("$.ring.events", "expected list")
    return doc


def load_incident(path: str) -> dict:
    with open(path) as f:
        return validate_incident(json.load(f))
