"""Trace spans: a ring-buffered JSONL event log for the serving stack
(port of ``repro/obs/trace.py``).

Every instrumented point in the request path (scheduler offer/route,
pool alloc/evict, backend prefill/decode, engine admit→free) appends one
event — a flat dict with a monotonic microsecond timestamp ``ts`` and an
event name ``ev`` — so one grep over the flushed file reconstructs any
request's timeline:

    {"ts": 1042, "ev": "sched.offer", "rid": 3, "ok": true}
    {"ts": 1180, "ev": "engine.prefill", "rid": 3, "dur_us": 95, ...}
    {"ts": 9021, "ev": "engine.free", "rid": 3, "sid": 7}

Design points:

  * ring buffer (``collections.deque(maxlen=...)``): a forgotten trace
    can never grow without bound; overflow evicts the oldest events and
    counts them in ``dropped``;
  * injectable clock: tests pass a fake monotonic clock and get
    byte-identical timelines; production uses ``time.monotonic`` with
    ``ts`` measured in integer microseconds since the log was created
    (small, diff-friendly numbers);
  * ``span(...)`` is a context manager that emits ONE event at exit
    carrying ``ts`` (entry time), ``dur_us`` and its nesting ``depth``
    — cheaper than begin/end pairs and trivially greppable.  The yielded
    dict is the event's field bag: instrumented code can add fields
    discovered mid-span (lane counts, staged blocks).

>>> clk = iter(range(100)).__next__
>>> t = TraceLog(clock=lambda: clk() * 1e-6)
>>> with t.span("engine.step", step=0) as sp:
...     sp["lanes"] = 4
...     t.event("engine.token", rid=1)
>>> [e["ev"] for e in t.events()]     # ordered by entry timestamp
['engine.step', 'engine.token']
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Iterator, Optional


class TraceLog:
    """Bounded, flushable event log with monotonic microsecond stamps."""

    def __init__(self, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None):
        self._clock = clock or time.monotonic
        self._t0 = self._clock()
        self._buf: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.dropped = 0        # events evicted by ring overflow
        self.total = 0          # events ever recorded
        self._depth = 0         # live span nesting level

    def now_us(self) -> int:
        return int(round((self._clock() - self._t0) * 1e6))

    def event(self, ev: str, **fields) -> None:
        """Record one instantaneous event."""
        self._append({"ts": self.now_us(), "ev": ev, **fields})

    @contextmanager
    def span(self, ev: str, **fields) -> Iterator[dict]:
        """Record a timed region as one event at exit.

        The event carries the entry timestamp, ``dur_us``, and the
        nesting ``depth`` at entry (0 = top level).  Yields the mutable
        field dict so callers can attach results discovered inside.
        """
        rec = {"ts": self.now_us(), "ev": ev, "depth": self._depth,
               **fields}
        self._depth += 1
        try:
            yield rec
        finally:
            self._depth -= 1
            rec["dur_us"] = self.now_us() - rec["ts"]
            self._append(rec)

    def _append(self, rec: dict) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(rec)
        self.total += 1

    def events(self) -> list:
        """Buffered events, oldest first (spans appear at exit time)."""
        return sorted(self._buf, key=lambda e: e["ts"])

    def lines(self) -> list:
        """Buffered events rendered as JSONL strings."""
        return [json.dumps(e, sort_keys=True) for e in self.events()]

    def flush(self, path: str) -> int:
        """Append buffered events to ``path`` as JSONL and clear the
        buffer; returns the number of events written."""
        evs = self.lines()
        with open(path, "a", encoding="utf-8") as fh:
            for line in evs:
                fh.write(line + "\n")
        self._buf.clear()
        return len(evs)
