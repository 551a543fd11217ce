"""Serving telemetry (port of ``repro/obs``): metrics registry, trace
spans, modelled row locality.

  ``obs.metrics``    counters / gauges / fixed-bucket histograms behind a
                     process-local registry, plus the ``StatGroup``
                     facade the pool, scheduler, engine and tiers keep
                     their counters in
  ``obs.trace``      ring-buffered JSONL event log with monotonic host
                     timestamps and nested spans
  ``obs.rowsim``     incremental open-row model on the paper's DRAM
                     address map (``core/dram``), feeding the modelled
                     row-hit % gauge
  ``obs.observer``   the ``Observer`` hub + ``attach(engine)`` wiring
                     and the shared ``shard_load_snapshot`` helper

Everything is stdlib + numpy and costs one ``is not None`` test per
instrumented site when disabled.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, StatGroup, exp_edges)
from repro_torch.obs.observer import Observer, shard_load_snapshot
from repro_torch.obs.rowsim import OpenRowCounter
from repro_torch.obs.trace import TraceLog

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatGroup",
    "exp_edges", "Observer", "shard_load_snapshot", "OpenRowCounter",
    "TraceLog",
]
