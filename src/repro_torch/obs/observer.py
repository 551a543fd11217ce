"""Observer: one attach point wiring the serving stack for telemetry (port
of ``repro/obs/observer.py``).

``Observer`` bundles the three obs primitives — a ``MetricsRegistry``, a
``TraceLog``, and per-shard ``OpenRowCounter``s — and ``attach(engine)``
threads it through every serving layer by setting each component's
``obs`` attribute (scheduler, pool(s), backend(s), tiers, engine) and
adopting their stats facades into the registry:

    engine.<field>        EngineStats        (steps, decode_tokens, ...)
    sched.<field>         SchedulerStats     (scheduled, shard_defers, ...)
    class.<name>.<field>  per-traffic-class counters and wait histograms
    pool.<field>          PoolStats of a single pool
    pool.shardN.<field>   per-shard PoolStats (sharded pools)
    tier.shardN.<field>   TierStats of each shard's spill tiers

Instrumented code pays ONE attribute test (``if self.obs is not None``)
when telemetry is off; see the reference's ``docs/OBSERVABILITY.md`` for
the metric-name catalogue and span schema, which this port keeps.

Every time here is host time: spans and the ``engine.*_ms`` histograms
read ``time.monotonic``/``time.perf_counter``.  On a CUDA device the
decode's device work becomes visible to the host in ``backend.decode``
(the blocking sync), so ``engine.dispatch_ms`` is launch time and
``engine.sync_ms`` the wait for the card.  No hook reads a tensor: every
event field is a host int the backend already holds, so telemetry never
synchronizes the card inside a dispatch.

The row-hit gauges (``dram.row_hit_pct``, ``tier.promote_row_hit_pct``)
are a model, not a reading of the card: ``OpenRowCounter`` on the
paper's LPDDR4-3200 address map (``core.dram.DramConfig``), fed the walk
of the reference's Pallas grid (``ops.kv_read_trace_kernel``, lanes one
after another) — neither HBM3 nor the order of the port's K1, which
walks page ranges of every lane at once.  They keep the reference's
names and numbers.

``shard_load_snapshot`` is the single per-shard load/occupancy summary
the routing layers consume (``ShardedBlockPool.route``/``least_loaded``
and ``ShardedPagedBackend.prefill``): the ``load`` and ``headroom``
columns are the pool's routing metric (live + reserved) and reservation
headroom (free + cached − reserved), so every consumer ranks shards by
the same numbers the gauges report.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.rowsim import OpenRowCounter
from repro_torch.obs.trace import TraceLog


def shard_load_snapshot(pool, registry: Optional[MetricsRegistry] = None
                        ) -> list:
    """Per-shard load summary of a ``BlockPool`` or ``ShardedBlockPool``.

    One row per shard (a single pool is one shard, index 0)::

        {"shard": i, "blocks": capacity, "live": .., "cached": ..,
         "free": .., "reserved": .., "load": live + reserved,
         "headroom": free + cached - reserved,
         "occupancy": (live + cached) / blocks}

    ``load`` is the routing metric (``ShardedBlockPool.load``);
    ``headroom`` is reservation capacity (``can_reserve(n)`` iff
    ``headroom >= n``).  With ``registry``, each row is also published
    as ``pool.shardN.{load,occupancy}`` gauges.
    """
    shards = pool.shards if getattr(pool, "is_sharded", False) else [pool]
    out = []
    for i, p in enumerate(shards):
        blocks = p.cfg.num_blocks
        live, cached, free = p.num_live, p.num_cached, p.num_free
        row = {"shard": i, "blocks": blocks, "live": live,
               "cached": cached, "free": free, "reserved": p.reserved,
               "load": live + p.reserved,
               "headroom": free + cached - p.reserved,
               "occupancy": (live + cached) / blocks if blocks else 0.0}
        if registry is not None:
            registry.set(f"pool.shard{i}.load", row["load"])
            registry.set(f"pool.shard{i}.occupancy", row["occupancy"])
        out.append(row)
    return out


class Observer:
    """Telemetry hub for one serving engine.

    Args:
      paranoid: run ``pool.check_invariants(incremental=True)`` every
        ``paranoid_every`` engine steps (the ``--metrics --paranoid``
        serve mode).
      row_cfg: DRAM config for the open-row model; ``None`` uses the
        paper's LPDDR4-3200 defaults.
      clock/capacity: forwarded to ``TraceLog`` (tests inject a fake
        clock for deterministic timelines).
    """

    def __init__(self, *, paranoid: bool = False, paranoid_every: int = 8,
                 row_cfg=None, clock=None, capacity: int = 65536):
        self.registry = MetricsRegistry()
        self.trace = TraceLog(capacity=capacity, clock=clock)
        self.paranoid = paranoid
        self.paranoid_every = max(1, paranoid_every)
        self._row_cfg = row_cfg
        self.rows: dict[int, OpenRowCounter] = {}
        # tier-boundary promotion copy-ins get their own open-row model:
        # the write stream is disjoint from the decode walk, so mixing
        # them would blur both gauges
        self.promo_rows: dict[int, OpenRowCounter] = {}
        self._engine = None

    # -- wiring --------------------------------------------------------------

    def attach(self, engine) -> "Observer":
        """Wire a ``ServeEngine`` (and everything below it) to this
        observer.  Idempotent; returns self for chaining."""
        self._engine = engine
        engine.obs = self
        self.registry.adopt("engine", engine.stats)
        engine.scheduler.obs = self
        self.registry.adopt("sched", engine.scheduler.stats)
        # per-traffic-class streams: counters adopt as
        # ``class.<name>.<field>``, and the scheduler's live wait-time
        # histograms alias in as ``class.<name>.wait_ms`` (the p50/p99
        # gauges are published by ``schedule_batch`` itself)
        for cname, cs in getattr(engine.scheduler, "class_stats",
                                 {}).items():
            self.registry.adopt(f"class.{cname}", cs)
        for cname, h in getattr(engine.scheduler, "wait_hist", {}).items():
            self.registry.attach_metric(f"class.{cname}.wait_ms", h)
        pool = engine.pool
        if getattr(pool, "is_sharded", False):
            pool.obs = self
            for i, p in enumerate(pool.shards):
                p.obs = self
                p.obs_shard = i
                self.registry.adopt(f"pool.shard{i}", p.stats)
        else:
            pool.obs = self
            pool.obs_shard = 0
            self.registry.adopt("pool", pool.stats)
        backend = getattr(engine.model, "backend", None)
        if backend is not None:
            inners = getattr(backend, "backends", None) or [backend]
            for i, b in enumerate(inners):
                b.obs = self
                b.obs_shard = i
                tiers = getattr(b, "tiers", None)
                if tiers is not None:
                    tiers.obs = self
                    tiers.obs_shard = i
                    self.registry.adopt(f"tier.shard{i}", tiers.stats)
                    tiers._publish()     # occupancy gauges exist from step 0
        return self

    # -- modelled row locality -----------------------------------------------

    def observe_kv_walk(self, shard: int, addrs) -> None:
        """Feed one decode step's page walk (64B-line ids from
        ``ops.kv_read_trace_kernel``) into shard ``shard``'s open-row
        model and refresh the (modelled) row-hit gauges."""
        rc = self.rows.get(shard)
        if rc is None:
            rc = self.rows[shard] = OpenRowCounter(self._row_cfg)
        rc.observe(addrs)
        self.registry.set(f"dram.shard{shard}.row_hit_pct",
                          100.0 * rc.row_hit_rate)
        hits = sum(r.hits for r in self.rows.values())
        served = sum(r.served for r in self.rows.values())
        self.registry.set("dram.row_hit_pct",
                          100.0 * hits / served if served else 0.0)
        self.registry.counter("dram.kv_lines").inc(
            0 if addrs is None else len(addrs))

    def observe_promotion(self, shard: int, addrs) -> None:
        """Feed one tier-promotion batch's copy-in write stream (64B-line
        ids from ``TierManager.write_trace``, already MARS-ordered by
        destination row group) into shard ``shard``'s promotion open-row
        model and refresh the ``tier.promote_row_hit_pct`` gauges."""
        rc = self.promo_rows.get(shard)
        if rc is None:
            rc = self.promo_rows[shard] = OpenRowCounter(self._row_cfg)
        rc.observe(addrs)
        self.registry.set(f"tier.shard{shard}.promote_row_hit_pct",
                          100.0 * rc.row_hit_rate)
        hits = sum(r.hits for r in self.promo_rows.values())
        served = sum(r.served for r in self.promo_rows.values())
        self.registry.set("tier.promote_row_hit_pct",
                          100.0 * hits / served if served else 0.0)

    # -- per-step bookkeeping (called by the engine) -------------------------

    def step_done(self, engine, dt_ms: float, lanes: int,
                  tokens: int) -> None:
        """End-of-step hook: step-latency histogram, occupancy/rate
        gauges, and (paranoid mode) the periodic incremental invariant
        sweep."""
        self.registry.observe("engine.step_ms", dt_ms)
        self.registry.set("engine.lanes", lanes)
        self.sample(engine)
        if self.paranoid and engine.stats.steps % self.paranoid_every == 0:
            engine.pool.check_invariants(incremental=True)

    def sample(self, engine) -> None:
        """Refresh derived gauges from the engine's pools and stats."""
        pool = engine.pool
        snap = shard_load_snapshot(pool, self.registry)
        blocks = sum(r["blocks"] for r in snap)
        live = sum(r["live"] for r in snap)
        cached = sum(r["cached"] for r in snap)
        self.registry.set("pool.occupancy",
                          (live + cached) / blocks if blocks else 0.0)
        st = pool.stats
        self.registry.set("kvcache.eviction_rate",
                          st.evictions / max(st.allocs, 1))
        es = engine.stats
        self.registry.set("kvcache.prefix_hit_rate",
                          es.shared_prompt_tokens / max(es.prefill_tokens, 1))
        backend = getattr(engine.model, "backend", None)
        if backend is not None:
            # decode-pipeline depth: 0 idle, 1 dispatched-unsynced or
            # synced-uncommitted, 2 both
            self.registry.set("backend.inflight_steps",
                              getattr(backend, "inflight_steps", 0))

    # -- surfacing -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The registry snapshot plus trace meta — what ``launch/serve.py
        --metrics`` writes as JSON."""
        out = self.registry.snapshot()
        out["trace"] = {"events": self.trace.total,
                        "dropped": self.trace.dropped}
        return out

    def summary_lines(self) -> list:
        """One-screen human summary of the headline metrics."""
        s = self.snapshot()
        g, c, h = s["gauges"], s["counters"], s["histograms"]
        step = h.get("engine.step_ms", {})
        lines = [
            f"row-hit % (modelled) {g.get('dram.row_hit_pct', 0.0):7.2f}"
            "  (reference grid order, LPDDR4 map; not HBM3)",
            f"prefix hit rate      {g.get('kvcache.prefix_hit_rate', 0.0):7.3f}",
            f"eviction rate        {g.get('kvcache.eviction_rate', 0.0):7.3f}",
            f"step latency ms      p50 {step.get('p50', 0.0):.3f} / "
            f"p99 {step.get('p99', 0.0):.3f}  (n={step.get('count', 0)}, "
            "host clock)",
            f"steps / tokens       {c.get('engine.steps', 0)} / "
            f"{c.get('engine.decode_tokens', 0)}",
        ]
        for name in sorted(n for n in g if n.endswith(".occupancy")
                           and n.startswith("pool.shard")):
            shard = name.split(".")[1]
            lines.append(f"{shard + ' occupancy':<21}{g[name]:7.3f}")
        lines.append(f"trace events         {s['trace']['events']} "
                     f"({s['trace']['dropped']} dropped)")
        return lines
