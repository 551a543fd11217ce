"""Serving telemetry (port): the metrics registry and ``StatGroup`` facade
the pool, scheduler and engine keep their counters in.  Trace spans and
the live row-locality model arrive with the observability slice."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatGroup, exp_edges)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatGroup",
    "exp_edges",
]
