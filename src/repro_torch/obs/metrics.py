"""Typed metrics registry — the single owner of engine telemetry (a copy
of the reference's ``repro/obs/metrics.py``; its Prometheus exporter is not
ported yet).

Three metric kinds, Prometheus-shaped and host-side:

* :class:`Counter`   — monotonically increasing value (``inc``); ``set`` is
  the reset/write-through escape hatch the legacy ``engine.stats`` dict
  API needs.
* :class:`Gauge`     — a current value plus a tracked **peak**.  The peak is
  what the legacy ``peak_kv_blocks`` / ``max_step_tokens`` stats keys
  report; ``reset_peak`` REBASES the peak to the current value (not to
  zero), so a run-stats reset on an engine that still holds blocks (e.g. a
  kept prefix cache) starts the new run's peak from reality instead of
  undercounting it.
* :class:`Histogram` — raw observations with nearest-rank percentile
  summaries ({p50, p90, p99, mean, max, n}).  TTFT/TPOT/queue live here,
  so serving drivers print tail latencies directly instead of replaying
  requests through an external runner.

Metrics may declare **labels** (``registry.counter("step_time_s",
labels=("phase",))``); ``.labels(phase="prefill")`` returns the child
metric for that label value, created on first use.  The registry is
*typed*: re-declaring a name as a different kind (or with different
labels) raises instead of silently aliasing.

:class:`StatsView` is the backward-compatibility surface: a mutable
mapping that reads and writes through to registry metrics under their
legacy key names, with a plain-dict side table for static entries
(plan/density telemetry).  ``dict(view)``, ``view.update(...)``,
``"key" in view`` all behave like the old ``engine.stats`` dict.
"""
from __future__ import annotations

from collections.abc import MutableMapping

import numpy as np

PERCENTILES = (50, 90, 99)

# Default latency bucket bounds (seconds) for the Prometheus histogram
# rendering in repro.obs.export — exact observations are kept, so buckets
# are derived at render time, not at observe time.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def empty_summary() -> dict:
    """The explicit sentinel for a histogram with no observations: the
    usual summary shape with numeric zeros (NaN-free, so snapshots stay
    strict-JSON- and Prometheus-safe) plus ``"empty": True`` — callers
    that care distinguish on the flag or on ``n == 0``, format sites that
    multiply ``p50 * 1e3`` keep working."""
    return {**{f"p{p}": 0.0 for p in PERCENTILES},
            "mean": 0.0, "max": 0.0, "n": 0, "empty": True}


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, v=1):
        self.value += v

    def set(self, v):
        """Write-through/reset hook for the legacy dict API."""
        self.value = v

    def reset(self):
        self.value = 0


class Gauge:
    """Current value + tracked peak."""

    __slots__ = ("name", "help", "value", "peak")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0
        self.peak = 0

    def set(self, v):
        self.value = v
        if v > self.peak:
            self.peak = v

    def inc(self, v=1):
        self.set(self.value + v)

    def reset_peak(self):
        """Rebase the peak to the CURRENT value (see module docstring)."""
        self.peak = self.value

    def reset(self):
        self.value = 0
        self.peak = 0


class Histogram:
    """Raw-observation histogram with percentile summaries.

    Serving runs are bounded (thousands of requests, not billions), so the
    honest representation — keep every observation, compute exact
    percentiles — beats bucketed approximation; ``max_obs`` bounds memory
    for pathological loops by dropping the OLDEST half when exceeded (tail
    percentiles of a long run care about recent steady state).
    """

    __slots__ = ("name", "help", "_obs", "max_obs")
    kind = "histogram"

    def __init__(self, name: str, help: str = "", max_obs: int = 1 << 20):
        self.name = name
        self.help = help
        self.max_obs = max_obs
        self._obs: list = []

    def observe(self, v):
        if v is None:
            return
        self._obs.append(float(v))
        if len(self._obs) > self.max_obs:
            self._obs = self._obs[len(self._obs) // 2:]

    @property
    def count(self) -> int:
        return len(self._obs)

    @property
    def sum(self) -> float:
        return float(np.sum(self._obs)) if self._obs else 0.0

    def percentile(self, p: float) -> float:
        if not self._obs:
            return float("nan")
        return float(np.percentile(np.asarray(self._obs), p))

    def cumulative_buckets(self, bounds: tuple = DEFAULT_BUCKETS) -> list:
        """Prometheus-style cumulative buckets over ``bounds`` plus the
        implicit +Inf bucket: ``[(le, n_obs <= le), ...]``."""
        xs = np.sort(np.asarray(self._obs, dtype=float))
        out = [(float(b), int(np.searchsorted(xs, b, side="right")))
               for b in bounds]
        out.append((float("inf"), int(xs.size)))
        return out

    def summary(self) -> dict:
        """{p50, p90, p99, mean, max, n} — the same shape as
        ``benchmarks.workloads.metrics.percentile_summary``.  Empty
        histograms return :func:`empty_summary` (NaN-free, ``empty``
        flag) instead of NaN fields, so ``latency_percentiles()`` on a
        fresh engine is safe to JSON-encode and render."""
        obs = list(self._obs)    # snapshot: scrape threads read concurrently
        if not obs:
            return empty_summary()
        xs = np.asarray(obs)
        out = {f"p{p}": float(np.percentile(xs, p)) for p in PERCENTILES}
        out["mean"] = float(xs.mean())
        out["max"] = float(xs.max())
        out["n"] = int(xs.size)
        return out

    def reset(self):
        self._obs = []


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """A labeled metric family: one child metric per label-value tuple."""

    __slots__ = ("name", "help", "labels_keys", "_cls", "_children")

    def __init__(self, name: str, cls, labels: tuple, help: str = ""):
        self.name = name
        self.help = help
        self.labels_keys = tuple(labels)
        self._cls = cls
        self._children: dict = {}

    @property
    def kind(self):
        return self._cls.kind

    def items(self):
        """``(labels_dict, child)`` pairs in creation order — the export
        renderer's iteration surface."""
        return [(dict(zip(self.labels_keys, key)), child)
                for key, child in self._children.items()]

    def labels(self, **kv):
        if set(kv) != set(self.labels_keys):
            raise ValueError(
                f"metric {self.name!r} declared labels {self.labels_keys}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[k]) for k in self.labels_keys)
        child = self._children.get(key)
        if child is None:
            lbl = ",".join(f"{k}={v}" for k, v in zip(self.labels_keys, key))
            child = self._cls(f"{self.name}{{{lbl}}}", self.help)
            self._children[key] = child
        return child

    def children(self):
        return list(self._children.values())


class MetricsRegistry:
    """Typed registry: declare-or-get by name, snapshot as a flat dict."""

    def __init__(self):
        self._metrics: dict = {}

    def _declare(self, name: str, kind: str, help: str, labels: tuple):
        existing = self._metrics.get(name)
        if existing is not None:
            ok = (existing.kind == kind
                  and isinstance(existing, _Family) == bool(labels)
                  and (not labels
                       or existing.labels_keys == tuple(labels)))
            if not ok:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{existing.kind}{getattr(existing, 'labels_keys', ())} "
                    f"— cannot re-declare as {kind}{tuple(labels)}")
            return existing
        cls = _KINDS[kind]
        m = _Family(name, cls, labels, help) if labels else cls(name, help)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", labels: tuple = ()):
        return self._declare(name, "counter", help, tuple(labels))

    def gauge(self, name: str, help: str = "", labels: tuple = ()):
        return self._declare(name, "gauge", help, tuple(labels))

    def histogram(self, name: str, help: str = "", labels: tuple = ()):
        return self._declare(name, "histogram", help, tuple(labels))

    def get(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list:
        return list(self._metrics)

    def metrics(self) -> dict:
        """``name -> metric-or-family`` in declaration order; families
        expose ``items()``.  This is the surface ``repro.obs.export``
        renders from."""
        return dict(self._metrics)

    def _flat(self):
        for m in self._metrics.values():
            if isinstance(m, _Family):
                yield from m.children()
            else:
                yield m

    def snapshot(self) -> dict:
        """Flat name -> value dict: counters and gauge values verbatim,
        gauge peaks as ``<name>_peak``, histograms as their percentile
        summary dicts."""
        out = {}
        for m in self._flat():
            if m.kind == "histogram":
                out[m.name] = m.summary()
            elif m.kind == "gauge":
                out[m.name] = m.value
                out[f"{m.name}_peak"] = m.peak
            else:
                out[m.name] = m.value
        return out

    def reset_run(self):
        """Per-run reset: counters to zero, histograms cleared, gauge peaks
        REBASED to their current values (gauge values are live state — a
        reset must not pretend the engine holds nothing)."""
        for m in self._flat():
            if m.kind == "gauge":
                m.reset_peak()
            else:
                m.reset()


class StatsView(MutableMapping):
    """Legacy ``engine.stats`` dict API over registry metrics.

    ``mapping`` is ``key -> (getter, setter)``; unknown keys fall through
    to a plain side dict (static init-time telemetry like ``plan_layers``).
    Key ORDER is mapping order then side-dict insertion order, so printing
    ``dict(stats)`` stays stable across runs.
    """

    def __init__(self, mapping: dict | None = None):
        self._map: dict = dict(mapping or {})
        self._extra: dict = {}

    def bind(self, key: str, getter, setter=None):
        self._map[key] = (getter, setter)

    def __getitem__(self, key):
        if key in self._map:
            return self._map[key][0]()
        return self._extra[key]

    def __setitem__(self, key, value):
        if key in self._map:
            _, setter = self._map[key]
            if setter is None:
                raise KeyError(f"stats key {key!r} is read-only")
            setter(value)
        else:
            self._extra[key] = value

    def __delitem__(self, key):
        del self._extra[key]

    def __iter__(self):
        yield from self._map
        yield from self._extra

    def __len__(self):
        return len(self._map) + len(self._extra)

    def __repr__(self):
        return f"StatsView({dict(self)!r})"
