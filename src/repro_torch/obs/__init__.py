"""Engine observability: the typed metrics registry and the no-op tracer."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, StatsView
from repro_torch.obs.trace import NULL_TRACER, NullTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "NullTracer", "NULL_TRACER",
]
