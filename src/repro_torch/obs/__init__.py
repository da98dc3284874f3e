"""Engine observability, the reference's ``repro/obs`` for the port: the
typed metrics registry, event tracing with pluggable sinks (memory,
streaming JSONL, ring, tee), incident snapshots, the Prometheus export and
the timeline CLI (``python -m repro_torch.obs.timeline``).  Each module is
a copy of its reference with the same on-disk formats, so either package
reads the other's traces, streams and incident files.  ``NULL_TRACER`` is
the no-op recorder the engine runs with by default."""
from repro_torch.obs.export import MetricsServer, TextfileWriter, start_server
from repro_torch.obs.incident import IncidentMonitor
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, StatsView
from repro_torch.obs.trace import (NULL_TRACER, EventTracer, MemorySink, NullTracer,
                                   RingSink, StreamingSink, TeeSink)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "EventTracer", "NullTracer", "NULL_TRACER",
    "MemorySink", "StreamingSink", "RingSink", "TeeSink",
    "IncidentMonitor", "MetricsServer", "TextfileWriter", "start_server",
]
