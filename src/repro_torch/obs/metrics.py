"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

The serving stack's observability spine.  Three metric kinds, all
dependency-free and cheap enough to live on the decode hot path:

  Counter    monotonically increasing count (``inc`` rejects negative
             deltas); the unit the per-component stats facades are built
             from.
  Gauge      last-write-wins instantaneous value (occupancy, row-hit %).
  Histogram  fixed bucket edges chosen at creation; ``observe`` is one
             bisect + add, and the snapshot reports count/sum plus
             p50/p99 by linear interpolation inside the owning bucket —
             no sample retention, so memory is O(buckets) forever.

``MetricsRegistry`` names metrics (dotted paths like
``pool.shard0.allocs``) and renders one deterministic ``snapshot()``
dict — same metrics + same values = byte-identical JSON, which is what
lets CI diff snapshots.

``StatGroup`` is the compatible facade that absorbed the ad-hoc
per-component stats dataclasses (``PoolStats`` / ``EngineStats`` /
``SchedulerStats``): subclasses declare integer/float fields in
``FIELDS``; instances expose them as plain attributes (reads return
numbers, ``stats.allocs += n`` updates the underlying ``Counter``), and
``MetricsRegistry.adopt`` publishes the *same* counter objects under a
prefix — component code and the registry can never skew because there is
only one copy of each number.

>>> reg = MetricsRegistry()
>>> reg.counter("pool.allocs").inc(3)
>>> reg.gauge("pool.occupancy").set(0.5)
>>> reg.snapshot()["counters"]["pool.allocs"]
3
"""
from __future__ import annotations

import bisect
from typing import Optional, Sequence


class Counter:
    """Monotonic counter.  ``value`` is directly writable (the stats
    facades assign through it); ``inc`` enforces monotonicity."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, value: float = 0):
        self.value = value

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, value: float = 0.0):
        self.value = value

    def set(self, v: float) -> None:
        self.value = v


def exp_edges(lo: float, hi: float, n: int) -> tuple:
    """``n`` geometrically spaced bucket edges from ``lo`` to ``hi``."""
    assert lo > 0 and hi > lo and n >= 2
    r = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * r ** i for i in range(n))


# engine-step latency default: 10us .. 100s, 48 geometric buckets
DEFAULT_MS_EDGES = exp_edges(0.01, 100_000.0, 48)


class Histogram:
    """Fixed-bucket histogram with interpolated quantile snapshots.

    ``edges`` are the bucket upper bounds; a value lands in the first
    bucket whose edge is >= value (bisect), with one extra overflow
    bucket past ``edges[-1]``.  Quantiles interpolate linearly within
    the owning bucket (overflow clamps to ``edges[-1]``), so p50/p99
    are deterministic functions of the counts — no samples kept.
    """

    kind = "histogram"

    def __init__(self, edges: Sequence[float] = DEFAULT_MS_EDGES):
        assert len(edges) >= 1 and list(edges) == sorted(edges)
        self.edges = tuple(float(e) for e in edges)
        self.counts = [0] * (len(self.edges) + 1)   # +1 = overflow
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """Interpolated q-quantile (0..1); 0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c:
                if i >= len(self.edges):          # overflow bucket
                    return self.edges[-1]
                lo = self.edges[i - 1] if i else 0.0
                hi = self.edges[i]
                return lo + (hi - lo) * max(target - cum, 0.0) / c
            cum += c
        return self.edges[-1]

    def to_snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6) if self.count else 0.0,
            "p50": round(self.quantile(0.50), 6),
            "p99": round(self.quantile(0.99), 6),
        }


class MetricsRegistry:
    """Named metrics + one deterministic snapshot.

    Metric creation is get-or-create by dotted name; asking for an
    existing name with a different kind raises (one name, one meaning).
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"wanted {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_MS_EDGES) -> Histogram:
        return self._get(name, Histogram, edges)

    # convenience write-throughs (hot paths keep the metric object instead)

    def inc(self, name: str, n: float = 1) -> None:
        self.counter(name).inc(n)

    def set(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def attach_metric(self, name: str, metric) -> None:
        """Publish an externally owned metric object (e.g. a component's
        live ``Histogram``) under ``name`` — aliasing like ``adopt``, so
        snapshots read the component's own values.  Idempotent for the
        same object; a different object under a taken name raises."""
        have = self._metrics.get(name)
        if have is None:
            self._metrics[name] = metric
        elif have is not metric:
            raise ValueError(f"metric {name!r} already registered")

    def adopt(self, prefix: str, group: "StatGroup") -> None:
        """Publish a stats facade's counters under ``prefix.<field>``.

        The registry holds the SAME ``Counter`` objects the facade
        mutates — adoption is aliasing, not copying, so snapshots always
        read the live values.  Re-adopting the same group is idempotent;
        adopting a different group under a taken name raises.
        """
        for field, counter in group.counters().items():
            name = f"{prefix}.{field}"
            have = self._metrics.get(name)
            if have is None:
                self._metrics[name] = counter
            elif have is not counter:
                raise ValueError(
                    f"metric {name!r} already adopted from another group")

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}},
        every section sorted by name — deterministic for identical
        metric states."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out["histograms"][name] = m.to_snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = _round(m.value)
            else:
                out["counters"][name] = _round(m.value)
        return out


def _round(v):
    return round(v, 6) if isinstance(v, float) else v


class StatGroup:
    """Attribute-compatible facade over ``Counter`` objects.

    Subclasses declare ``FIELDS`` (name -> default).  Instances read and
    write the fields like the dataclasses they replaced
    (``stats.allocs += n``), keyword construction still works
    (``PoolStats(allocs=3)``), and ``counters()`` exposes the live
    ``Counter`` objects for ``MetricsRegistry.adopt``.
    """

    FIELDS: dict[str, float] = {}

    def __init__(self, **kw):
        stats = {f: Counter(kw.pop(f, d)) for f, d in self.FIELDS.items()}
        if kw:
            raise TypeError(f"unknown stats field(s): {sorted(kw)}")
        object.__setattr__(self, "_stats", stats)

    def __getattr__(self, name):
        stats = object.__getattribute__(self, "_stats")
        try:
            return stats[name].value
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        try:
            self._stats[name].value = value
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no stats field {name!r}") \
                from None

    def counters(self) -> dict[str, Counter]:
        return dict(self._stats)

    def fields(self) -> tuple:
        return tuple(self.FIELDS)

    def as_dict(self) -> dict:
        return {f: c.value for f, c in self._stats.items()}

    def __repr__(self):
        body = ", ".join(f"{f}={c.value}" for f, c in self._stats.items())
        return f"{type(self).__name__}({body})"

    def __eq__(self, other):
        return isinstance(other, StatGroup) and \
            self.as_dict() == other.as_dict()
