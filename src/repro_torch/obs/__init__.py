"""Serving telemetry (port): the metrics registry and ``StatGroup`` facade
the pool, scheduler, engine and tiers keep their counters in, and
``observer.shard_load_snapshot``, the per-shard load summary the shard
routing reads.  Trace spans, the ``Observer`` hub and the live
row-locality model arrive with the observability slice."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatGroup, exp_edges)
from repro_torch.obs.observer import shard_load_snapshot

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatGroup",
    "exp_edges", "shard_load_snapshot",
]
