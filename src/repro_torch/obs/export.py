"""Metrics export surface: Prometheus text exposition over the typed
registry, a stdlib scrape endpoint, and a textfile writer (a copy of the
reference's ``repro/obs/export.py``: the same text, sample for sample).

:func:`render` turns a :class:`~repro_torch.obs.metrics.MetricsRegistry` into
Prometheus text-exposition format (version 0.0.4).  The mapping keeps an
exact correspondence with ``registry.snapshot()`` so a scrape can be
checked against the in-process snapshot sample-for-sample:

* **counters** — one sample per (family child), value verbatim.  No
  ``_total`` suffix is appended: the registry names are the contract the
  snapshot/baseline machinery already pins, and renaming on export would
  break the snapshot == scrape identity the tests assert.
* **gauges** — the live value, plus a second ``<name>_peak`` gauge for the
  tracked peak (mirroring the ``<name>_peak`` snapshot key).
* **histograms** — exact observations rendered as cumulative
  ``<name>_bucket{le="..."}`` samples over
  :data:`~repro_torch.obs.metrics.DEFAULT_BUCKETS` plus ``+Inf``, with
  ``<name>_sum`` / ``<name>_count``, and — because the registry keeps raw
  observations, not buckets — *exact* quantiles as
  ``<name>_quantile{quantile="0.5|0.9|0.99"}`` plus ``<name>_mean`` /
  ``<name>_max`` gauges matching the summary dict.

:class:`MetricsServer` serves ``/metrics`` (text) and ``/metrics.json``
(the raw snapshot) from a daemon-threaded stdlib ``http.server`` — no
dependency on a Prometheus client library, per the no-new-deps rule.
:class:`TextfileWriter` atomically rewrites a ``.prom`` file on an
interval for scrape-less environments (node-exporter textfile collector
style).  Both read the registry live; metric mutation is single-threaded
(the engine loop) and reads take list-copies, so a scrape mid-step sees a
consistent-enough view without locks.
"""
from __future__ import annotations

import json
import math
import os
import threading

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import DEFAULT_BUCKETS

NAMESPACE = "tsar"

_QUANTILES = (("0.5", 50), ("0.9", 90), ("0.99", 99))

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v) -> str:
    """Prometheus sample-value formatting: ints verbatim, floats via
    ``repr`` (shortest round-trip), infinities as +Inf/-Inf."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _sample(name: str, labels: dict, value) -> str:
    if labels:
        lbl = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
        return f"{name}{{{lbl}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def _help_line(name: str, help_text: str) -> str:
    text = (help_text or name).replace("\\", r"\\").replace("\n", " ")
    return f"# HELP {name} {text}"


def render(registry, namespace: str = NAMESPACE,
           buckets: tuple = DEFAULT_BUCKETS) -> str:
    """Registry -> Prometheus text exposition (see module docstring for
    the sample mapping)."""
    lines: list = []

    def emit(name, kind, help_text, samples):
        lines.append(_help_line(name, help_text))
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(samples)

    for name, m in registry.metrics().items():
        full = f"{namespace}_{name}" if namespace else name
        children = m.items() if hasattr(m, "items") else [({}, m)]
        if m.kind == "counter":
            emit(full, "counter", m.help,
                 [_sample(full, lb, c.value) for lb, c in children])
        elif m.kind == "gauge":
            emit(full, "gauge", m.help,
                 [_sample(full, lb, c.value) for lb, c in children])
            emit(f"{full}_peak", "gauge", f"peak of {name}",
                 [_sample(f"{full}_peak", lb, c.peak) for lb, c in children])
        elif m.kind == "histogram":
            hist_samples: list = []
            gauge_specs = [("_mean", "mean"), ("_max", "max")]
            extra: dict = {suffix: [] for suffix, _ in gauge_specs}
            quantile_samples: list = []
            for lb, c in children:
                s = c.summary()
                for le, n in c.cumulative_buckets(buckets):
                    le_s = "+Inf" if math.isinf(le) else _fmt(le)
                    hist_samples.append(
                        _sample(f"{full}_bucket", {**lb, "le": le_s}, n))
                hist_samples.append(_sample(f"{full}_sum", lb, c.sum))
                hist_samples.append(_sample(f"{full}_count", lb, c.count))
                for q, p in _QUANTILES:
                    quantile_samples.append(
                        _sample(f"{full}_quantile", {**lb, "quantile": q},
                                s[f"p{p}"]))
                for suffix, key in gauge_specs:
                    extra[suffix].append(_sample(f"{full}{suffix}", lb, s[key]))
            emit(full, "histogram", m.help, hist_samples)
            emit(f"{full}_quantile", "gauge",
                 f"exact quantiles of {name}", quantile_samples)
            for suffix, key in gauge_specs:
                emit(f"{full}{suffix}", "gauge", f"{key} of {name}",
                     extra[suffix])
    return "\n".join(lines) + "\n"


def parse_samples(text: str) -> dict:
    """Exposition text -> ``{'name{label=\"v\"}' : float}`` — the inverse
    of :func:`render` at sample granularity, for tests that assert a
    scrape matches ``registry.snapshot()``."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        out[key] = float(val)
    return out


# ---------------------------------------------------------------------------
# scrape endpoint + textfile writer
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    registry = None
    namespace = NAMESPACE

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path in ("/", "/metrics"):
            body = render(self.registry, self.namespace).encode("utf-8")
            ctype = _CONTENT_TYPE
        elif path == "/metrics.json":
            body = json.dumps(self.registry.snapshot(),
                              sort_keys=True).encode("utf-8")
            ctype = "application/json"
        else:
            self.send_error(404, "try /metrics or /metrics.json")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass    # scrapes must not spam the engine's stdout


class MetricsServer:
    """Daemon-threaded scrape endpoint over a live registry.

    ``port=0`` binds an ephemeral port (``.port`` reports the real one) —
    what tests use; ``launch/serve.py --metrics-port`` passes a fixed one.
    """

    def __init__(self, registry, *, port: int = 0, host: str = "127.0.0.1",
                 namespace: str = NAMESPACE):
        handler = type("BoundMetricsHandler", (_Handler,),
                       {"registry": registry, "namespace": namespace})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tsar-metrics",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def start_server(registry, port: int = 0, **kw) -> MetricsServer:
    """Convenience: construct + start a :class:`MetricsServer`."""
    return MetricsServer(registry, port=port, **kw).start()


class TextfileWriter:
    """Periodically render the registry into a textfile (atomic
    tmp + ``os.replace``) for scrape-less environments.  ``write_once``
    is the synchronous core; ``start()`` spins a daemon thread that
    rewrites every ``interval_s`` and ``stop()`` joins it after one final
    write, so the file always ends at the run's last state."""

    def __init__(self, registry, path: str, *, interval_s: float = 5.0,
                 namespace: str = NAMESPACE):
        self.registry = registry
        self.path = str(path)
        self.interval_s = float(interval_s)
        self.namespace = namespace
        self.n_writes = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def write_once(self) -> str:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            f.write(render(self.registry, self.namespace))
        os.replace(tmp, self.path)
        self.n_writes += 1
        return self.path

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tsar-metrics-textfile", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.write_once()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
