"""MARS request scheduler — the paper's architecture as a serving frontend.

This is the *online* software rendering of MARS (the kernels are the bulk
rendering).  Incoming inference requests are the interleaved streams; the
"physical page" is the KV-prefix block (requests sharing a prompt prefix
hit the same cache pages and the same expert routing neighborhoods).  The
three paper structures map 1:1:

  RequestQ       -> bounded request buffer (``request_q`` entries)
  PhyPageList    -> dict keyed by prefix-block hash, holding per-page FIFO
                    lists (set-associativity bounds tracked pages, exactly
                    like the 2-way SRAM table)
  PhyPageOrderQ  -> drain the page holding the oldest buffered request
                    (core/mars._forward) -> bounded delay (no starvation)
                    while batches stay page-coherent

``schedule_batch`` is a two-stage SMS pipeline (staged memory scheduler,
arxiv 1804.11043) when traffic classes are configured:

  stage 1  per-class batch formation (``_form_batch``): each class is one
           source stream with its own PhyPageList, drained by the MARS
           oldest-page rule above, bounded by a per-class admission
           ``quota`` — so MARS page routing (and per-shard prefix
           co-location) is preserved *within* every stream;
  stage 2  batch scheduling (``_class_order``): latency classes first,
           behind an aging escape hatch that promotes any bandwidth class
           whose oldest request has waited past ``max_age`` (no
           starvation), then throughput classes by batch-fill (most
           buffered first).

With ``classes=None`` (the default) there is a single implicit stream
and the pipeline degenerates to the original MARS drain — the class-blind
baseline the mixed-traffic bench compares against.  With MARS off it pops
FIFO — the class-blind baseline below *that*.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.obs.metrics import Histogram, StatGroup, exp_edges

# per-class wait-time histograms: 0.01ms .. 1e7ms (fake serve clocks count
# whole steps as seconds, so the span must hold thousands of seconds)
WAIT_MS_EDGES = exp_edges(0.01, 10_000_000.0, 64)


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One SMS source stream: a named traffic class with its admission
    policy knobs.

    latency      latency-sensitive (interactive): scheduled ahead of
                 throughput classes, and an arrival of this class bouncing
                 on capacity raises the scheduler's preemption hint.
    quota        max admissions per ``schedule_batch`` call (0 = no cap) —
                 the per-stream batch-formation bound of SMS stage 1.
    queue_depth  max buffered requests of this class (0 = no cap); beyond
                 it ``offer`` rejects with reason "class_depth".
    max_age      aging escape hatch, in serve-clock seconds: a non-latency
                 class whose oldest buffered request has waited at least
                 this long is scheduled ahead of the latency classes
                 (0 = never ages).  Bounds bandwidth-class delay so
                 latency-first cannot starve anyone.
    """
    name: str
    latency: bool = False
    quota: int = 0
    queue_depth: int = 0
    max_age: float = 0.0


def default_classes(n: int = 3) -> tuple:
    """The stock interactive / batch / long-context-stream mix the
    ``--classes N`` serve flag installs (first ``n`` of the presets)."""
    presets = (
        TrafficClass("interactive", latency=True),
        TrafficClass("batch", quota=2, max_age=8.0),
        TrafficClass("stream", quota=1, max_age=12.0),
    )
    assert 1 <= n <= len(presets), f"--classes supports 1..{len(presets)}"
    return presets[:n]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: tuple           # token tuple (hashable)
    arrival: float = 0.0
    prefix_len: int = 64    # block size for page hashing
    max_new: int = 16
    n_samples: int = 1      # parallel samples (forked lanes, CoW tails)
    traffic_class: str = "default"   # SMS source stream this request joins

    @property
    def page(self) -> str:
        block = self.prompt[:self.prefix_len]
        return hashlib.sha1(repr(block).encode()).hexdigest()[:12]

    def blocks_needed(self, block_size: int) -> int:
        """Worst-case (no prefix sharing) KV blocks over the full lifetime,
        counting every forked sample as its own sequence."""
        return -(-(len(self.prompt) + self.max_new) // block_size) \
            * self.n_samples


class SchedulerStats(StatGroup):
    """Scheduling counters as an ``obs.metrics.StatGroup`` facade (same
    attribute API as the old dataclass; a ``MetricsRegistry`` adopts the
    live counters).  The derived ratios stay plain properties."""
    FIELDS = {"scheduled": 0, "batches": 0, "page_switches": 0,
              "stall_rejects": 0, "pool_rejects": 0,
              # sharded pool: no shard had headroom yet
              "shard_defers": 0, "wait_sum": 0.0}

    @property
    def pages_per_batch(self) -> float:
        return self.page_switches / max(self.batches, 1)

    @property
    def mean_wait(self) -> float:
        """Aggregate mean wait over ALL classes — a capacity summary, not
        a latency metric.  Per-class latency lives in ``ClassStats`` /
        the ``class.<name>.*`` histograms: averaging interactive and batch
        waits together was the bug this split fixes."""
        return self.wait_sum / max(self.scheduled, 1)


class ClassStats(StatGroup):
    """Per-traffic-class counters (one group per configured class,
    adopted by the registry as ``class.<name>.<field>``)."""
    FIELDS = {"admit": 0, "reject": 0, "defer": 0, "preempt": 0,
              "scheduled": 0, "wait_sum": 0.0}

    @property
    def mean_wait(self) -> float:
        return self.wait_sum / max(self.scheduled, 1)


class MarsScheduler:
    """Bounded-lookahead, page-grouping, oldest-page-first batcher with
    SMS-staged traffic classes on top (see module docstring)."""

    def __init__(self, request_q: int = 512, page_entries: int = 128,
                 ways: int = 2, mars: bool = True, pool=None,
                 classes: Optional[Sequence[TrafficClass]] = None):
        self.request_q = request_q
        self.page_entries = page_entries
        self.nsets = page_entries // ways
        self.ways = ways
        self.mars = mars
        cl = list(classes) if classes else [TrafficClass("default")]
        assert len({c.name for c in cl}) == len(cl), "duplicate class names"
        self.classes: dict[str, TrafficClass] = {c.name: c for c in cl}
        self._default_cls = cl[0].name   # unknown tags fall back here
        # per-class PhyPageList: class -> page -> FIFO of requests.  The
        # ways table stays GLOBAL (one SRAM analog): a page buffered by
        # two classes holds one way, released when the last class drains
        # it (``_page_classes`` tracks the holders).
        self.pages: dict[str, "OrderedDict[str, deque]"] = \
            {c.name: OrderedDict() for c in cl}
        self._page_classes: dict[str, set] = {}
        self.setload: dict[int, set] = {}
        self.fifo: deque = deque()
        self.total = 0
        self._cls_total: dict[str, int] = {c.name: 0 for c in cl}
        self.stats = SchedulerStats()
        self.class_stats: dict[str, ClassStats] = \
            {c.name: ClassStats() for c in cl}
        self.wait_hist: dict[str, Histogram] = \
            {c.name: Histogram(WAIT_MS_EDGES) for c in cl}
        # overload signal for the engine: a latency-class request just
        # bounced on capacity (offer reject) or deferred (no shard
        # headroom) — preempting a running throughput decode would free
        # the headroom it needs.  Cleared by ``take_preempt_hint``.
        self.preempt_wanted = False
        # KV block pool (``kvcache.BlockPool``): admission is bounded by
        # physical cache capacity, not just RequestQ entries.  A request's
        # worst-case block need is reserved in the pool at offer(); the
        # engine converts the reservation into real allocations as the
        # sequence grows and releases the remainder when it finishes
        # (reservations must outlive scheduling — decode blocks are
        # allocated lazily, long after the batch was formed).
        self.pool = pool
        self._seq = 0                            # arrival counter
        self.obs = None          # telemetry hook (obs.Observer.attach)
        # tiered KV memory (sharded pools): optional probe mapping a
        # prompt to the shard whose spill tiers hold its prefix
        # (``ShardedPagedBackend.tier_shard_for``) — admission counts a
        # promotable lower-tier hit toward affinity routing, so the
        # request lands where its demoted blocks are instead of
        # recomputing them elsewhere
        self.tier_probe = None

    def _set_of(self, page: str) -> int:
        return int(page, 16) % self.nsets

    def _class_of(self, req: Request) -> str:
        name = getattr(req, "traffic_class", self._default_cls)
        return name if name in self.classes else self._default_cls

    def offer(self, req: Request) -> bool:
        """Insert (paper Fig 5).  False = backpressure to the client."""
        ok, reason = self._offer(req)
        if self.obs is not None:
            self.obs.trace.event("sched.offer", rid=req.rid,
                                 page=req.page, ok=ok, reason=reason)
        return ok

    def _offer(self, req: Request) -> tuple:
        """(accepted, reason) — reason names the reject path ("ok",
        "queue_full", "class_depth", "pool_capacity", "page_ways")."""
        cname = self._class_of(req)
        cls = self.classes[cname]
        cs = self.class_stats[cname]
        req._cls = cname
        if self.total >= self.request_q:
            self.stats.stall_rejects += 1
            cs.reject += 1
            return False, "queue_full"
        if cls.queue_depth and self._cls_total[cname] >= cls.queue_depth:
            self.stats.stall_rejects += 1
            cs.reject += 1
            return False, "class_depth"
        if self.pool is not None:
            if not self.pool.can_reserve(
                    req.blocks_needed(self.pool.cfg.block_size)):
                self.stats.pool_rejects += 1
                cs.reject += 1
                if cls.latency:
                    self.preempt_wanted = True
                return False, "pool_capacity"
        page = req.page
        pages = self.pages[cname]
        if page not in pages:
            if not self._page_classes.get(page):
                # page tracked by no class yet: it needs a ways slot
                s = self._set_of(page)
                ways = self.setload.setdefault(s, set())
                if len(ways) >= self.ways:
                    self.stats.stall_rejects += 1
                    cs.reject += 1
                    return False, "page_ways"
                ways.add(page)
            self._page_classes.setdefault(page, set()).add(cname)
            pages[page] = deque()
        req._seq = self._seq            # arrival stamp: drain-order key
        self._seq += 1
        pages[page].append(req)
        self.fifo.append(req)
        self.total += 1
        self._cls_total[cname] += 1
        cs.admit += 1
        if self.pool is not None:
            self.pool.reserve(req.blocks_needed(self.pool.cfg.block_size))
        return True, "ok"

    def _route_shard(self, r: Request) -> bool:
        """Sharded pools only: commit ``r``'s aggregate admission
        reservation to a concrete shard (``ShardedBlockPool.route`` —
        prefix-page affinity first, then least shard load), stamping the
        choice on ``r._shard`` for the engine to honor at prefill.

        False = no shard has headroom *right now*; the request stays
        buffered (its ``_seq`` keeps its drain priority) and its class's
        formation stops so the class's oldest request is never skipped —
        bounded delay is preserved, admission just waits for running
        sequences to free their shard.  A deferred *latency*-class
        request additionally raises the preemption hint.  Single pools
        always return True.
        """
        if self.pool is None or not getattr(self.pool, "is_sharded", False):
            return True
        if getattr(r, "_shard", None) is not None:
            return True              # already routed (re-scheduled batch)
        hint = None if self.tier_probe is None \
            else self.tier_probe(r.prompt)
        shard = self.pool.route(
            r.rid, r.page, r.blocks_needed(self.pool.cfg.block_size),
            tier_hint=hint)
        if shard is None:
            self.stats.shard_defers += 1
            cname = getattr(r, "_cls", self._default_cls)
            self.class_stats[cname].defer += 1
            if self.classes[cname].latency:
                self.preempt_wanted = True
            if self.obs is not None:
                self.obs.trace.event("sched.defer", rid=r.rid,
                                     traffic_class=cname)
            return False
        r._shard = shard
        if self.obs is not None:
            self.obs.trace.event("sched.route", rid=r.rid, shard=shard)
        return True

    # -- stage 2: batch scheduling policy -----------------------------------

    def _class_order(self, now: float) -> list:
        """Which stream to drain next (SMS stage 2): aged bandwidth
        classes first (the no-starvation escape hatch — their oldest
        request has waited past ``max_age``), then latency classes, then
        throughput classes by batch-fill (most buffered first).  Ties
        break toward the older head request."""
        live = [c for c in self.classes.values()
                if self._cls_total[c.name] > 0]
        if len(live) <= 1:
            return live

        def head(c):
            pages = self.pages[c.name]
            return min((q[0] for q in pages.values()),
                       key=lambda r: r._seq)

        aged, lat, thru = [], [], []
        for c in live:
            h = head(c)
            if not c.latency and c.max_age > 0 \
                    and now - h.arrival >= c.max_age:
                aged.append((h._seq, c.name))
            elif c.latency:
                lat.append((h._seq, c.name))
            else:
                thru.append((-self._cls_total[c.name], h._seq, c.name))
        names = [n for _, n in sorted(aged)] \
            + [n for _, n in sorted(lat)] \
            + [n for _, _, n in sorted(thru)]
        return [self.classes[n] for n in names]

    # -- stage 1: per-class batch formation ---------------------------------

    def _form_batch(self, cls: TrafficClass, budget: int, cost_fn, out: list,
                    last_page) -> tuple:
        """Drain class ``cls``'s oldest pages to exhaustion (paper Fig 6
        scoped to one source stream), bounded by the shared lane
        ``budget`` and the class admission ``quota``.  Appends to ``out``
        and returns (budget, last_page, admitted)."""
        pages = self.pages[cls.name]
        quota = cls.quota if cls.quota > 0 else (1 << 30)
        n = 0
        deferred = False
        while pages and budget > 0 and n < quota and not deferred:
            # the page holding the oldest buffered request (the MARS
            # forward rule, core/mars._forward) — unlike oldest-page-
            # -allocation order, this bounds delay even when one hot
            # page refills faster than batches drain it
            page = min(pages, key=lambda p: pages[p][0]._seq)
            q = pages[page]
            if cost_fn(q[0]) > budget:
                break
            if not self._route_shard(q[0]):
                break
            if page != last_page:
                self.stats.page_switches += 1
                last_page = page
            while q and cost_fn(q[0]) <= budget and n < quota:
                if not self._route_shard(q[0]):
                    deferred = True
                    break
                r = q.popleft()
                try:
                    self.fifo.remove(r)
                except ValueError:
                    pass
                out.append(r)
                budget -= cost_fn(r)
                self.total -= 1
                self._cls_total[cls.name] -= 1
                n += 1
            if not q:
                self._drop_page(page, cls.name)
        return budget, last_page, n

    def schedule_batch(self, batch_size: int, now: float | None = None,
                       cost_fn=None) -> list:
        """Forward (paper Fig 6), SMS-staged: ``_class_order`` picks the
        stream, ``_form_batch`` drains it page-major.

        ``batch_size`` is a budget; each request costs ``cost_fn(r)``
        (default 1 — e.g. the engine charges one lane per forked sample).
        Scheduling stops before the first request that would overrun it.

        With a sharded pool every admitted request is additionally routed
        to a shard (``_route_shard``): page-grouped draining means the
        whole page's requests land on one shard back-to-back — the
        co-location that makes per-shard prefix caches hit.
        """
        now = time.time() if now is None else now
        cost_fn = cost_fn or (lambda r: 1)
        budget = batch_size
        out: list[Request] = []
        if not self.mars:
            # class-blind FIFO baseline
            while self.fifo and cost_fn(self.fifo[0]) <= budget \
                    and self._route_shard(self.fifo[0]):
                r = self.fifo.popleft()
                cname = getattr(r, "_cls", self._default_cls)
                q = self.pages[cname].get(r.page)
                if q and r in q:
                    q.remove(r)
                    if not q:
                        self._drop_page(r.page, cname)
                    out.append(r)
                    budget -= cost_fn(r)
                    self.total -= 1
                    self._cls_total[cname] -= 1
        else:
            last_page = None
            for cls in self._class_order(now):
                if budget <= 0:
                    break
                budget, last_page, _ = self._form_batch(
                    cls, budget, cost_fn, out, last_page)
        self.stats.scheduled += len(out)
        self.stats.batches += 1 if out else 0
        # wait accounting, split per class (the old single aggregate let a
        # deferred batch request inflate the interactive latency stats).
        # clamp per-request: a request admitted before its arrival clock
        # tick (offline replay drives `now` coarser than arrivals) has
        # waited nothing, and the aggregate must never go negative
        admitted: dict[str, int] = {}
        for r in out:
            w = max(now - r.arrival, 0.0)
            cname = getattr(r, "_cls", self._default_cls)
            cs = self.class_stats[cname]
            cs.scheduled += 1
            cs.wait_sum += w
            self.wait_hist[cname].observe(w * 1e3)
            self.stats.wait_sum += w
            admitted[cname] = admitted.get(cname, 0) + 1
        if self.obs is not None and out:
            self.obs.trace.event(
                "sched.batch", classes=admitted,
                quotas={c: self.classes[c].quota for c in admitted})
            for cname in admitted:
                h = self.wait_hist[cname]
                self.obs.registry.set(f"class.{cname}.p50_ms",
                                      h.quantile(0.50))
                self.obs.registry.set(f"class.{cname}.p99_ms",
                                      h.quantile(0.99))
        return out

    # -- preemption signalling (consumed by serve/engine.py) ----------------

    def take_preempt_hint(self) -> bool:
        """True once per overload signal: a latency-class request bounced
        on pool capacity or deferred on shard headroom since the last
        call.  The engine responds by pausing a running throughput-class
        decode (``ServeEngine._maybe_preempt``)."""
        hint, self.preempt_wanted = self.preempt_wanted, False
        return hint

    def note_preempt(self, cname: str) -> None:
        """Engine callback: one running decode of class ``cname`` was
        paused to free headroom."""
        cs = self.class_stats.get(cname)
        if cs is None:
            cs = self.class_stats[self._default_cls]
        cs.preempt += 1

    def _drop_page(self, page: str, cname: str) -> None:
        self.pages[cname].pop(page, None)
        owners = self._page_classes.get(page)
        if owners is not None:
            owners.discard(cname)
            if owners:       # another class still buffers this page
                return
            del self._page_classes[page]
        self.setload.get(self._set_of(page), set()).discard(page)

    def __len__(self) -> int:
        return self.total


def unique_prefix_blocks(batch: list) -> int:
    """Distinct KV prefix blocks a batch touches (the serving CAS/ACT)."""
    return len({r.page for r in batch})
