"""Mesh-sharded block pools: device-aware MARS placement, one level up
(port of ``repro/kvcache/sharded_pool.py``).

The paper's argument is about one memory device: give the controller a
large enough lookahead and interleaved streams can be reordered by
row-buffer address to recover locality.  With multiple memory *devices*
(a mesh of accelerators, each with its own memory) the same argument
applies one level up: a stream must first be routed to the right device
before row-group placement within that device can help — the
heterogeneous multi-source problem of staged memory scheduling
(Ausavarungnirun et al.).

``ShardedBlockPool`` partitions a ``BlockPool`` across the shards of a
device mesh: one independent per-shard ``BlockPool`` (its own free list,
refcounts, prefix storage and KV buffer), so the full placement key for
a block becomes

    (shard, row_group, block)        -- see ``placement.placement_key``

with the **device/shard coordinate leading** the existing bank+row-group
key: a sequence's blocks all land on one shard (chosen once, at
admission) and MARS row-group packing happens *within* that shard.
Copy-on-write forks allocate from the parent's shard pool, so forks stay
shard-local by construction.

Routing (``route``) is what the ``MarsScheduler`` calls when it admits a
request into a batch:

  1. **prefix-page affinity** — requests whose prompts hash to a page
     already routed keep going to the same shard, so shared prefixes
     co-locate and the per-shard prefix caches actually hit;
  2. **shard load** — otherwise the least-loaded shard (live + reserved
     blocks) with enough headroom wins, balancing KV footprint.

Reservations are two-phase because the scheduler reserves *before* it
routes: ``reserve`` books capacity against the aggregate pool at
``offer`` time (a sequence must fit on a single shard, so ``can_reserve``
also requires the request to fit one shard's capacity); ``route`` then
converts the aggregate booking into a concrete per-shard reservation at
schedule time, and may return ``None`` (leave the request queued) when
no shard currently has headroom.  ``unreserve`` releases a routed
request's shard reservation as the engine claims real allocations.

Mesh discovery reuses the ambient registry: with ``n_shards=None`` the
shard count comes from the mesh's model axis (``sharding.rules
.pool_shard_count`` over ``sharding.context.current_mesh()`` or an
explicit ``mesh=``); ``launch/mesh.py`` builds the serving mesh.  On
one GPU every shard's pool, mirror and kernels share the one device.

>>> from repro_torch.kvcache.pool import PoolConfig
>>> sp = ShardedBlockPool(PoolConfig(num_blocks=16, block_size=4),
...                       n_shards=2)
>>> sp.n_shards, sp.shards[0].cfg.num_blocks
(2, 8)
>>> sp.reserve(2)
>>> sp.route(rid=0, page="a", n=2)          # least-loaded: shard 0
0
>>> sp.reserve(2); sp.route(rid=1, page="a", n=2)   # page affinity sticks
0
>>> sp.unreserve(2, rid=0); sp.unreserve(2, rid=1)
>>> sp.reserved
0
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kvcache.pool import BlockPool, PoolConfig, PoolStats
from repro_torch.obs.observer import shard_load_snapshot

# sticky page->shard affinity entries kept (LRU beyond this); bounds the
# map under a stream of unique prompts while vastly exceeding any
# plausible simultaneously-hot prefix count
PAGE_AFFINITY_CAP = 4096


def discover_shards(n_shards: Optional[int], mesh=None) -> int:
    """Resolve a shard count: an explicit ``n_shards`` wins; otherwise
    the model-axis size of ``mesh`` (or the ambient
    ``sharding.context.current_mesh()``), 1 without a mesh.  The single
    discovery routine shared by ``ShardedBlockPool``,
    ``ShardedPagedBackend`` and ``make_backend`` sizing."""
    if n_shards is not None:
        return n_shards
    from repro_torch.sharding import context, rules
    return rules.pool_shard_count(
        mesh if mesh is not None else context.current_mesh())


class ShardedBlockPool:
    """One ``BlockPool`` per shard of the mesh's model axis.

    Invariants:
      * every block lives in exactly one shard pool; block ids are
        shard-local (the global placement key is ``(shard, group, id)``);
      * ``reserved == pending (offered, unrouted) + sum of per-shard
        reservations (routed)``, and a routed request's reservation sits
        entirely on its one shard;
      * per-shard pools never share blocks — cross-shard sharing is
        impossible, which is exactly what keeps CoW forks shard-local.
    """

    is_sharded = True     # duck-type marker for scheduler/engine branches

    def __init__(self, cfg: PoolConfig, n_shards: Optional[int] = None,
                 mesh=None):
        """Partition ``cfg.num_blocks`` across ``n_shards`` pools.

        Args:
          cfg: the *aggregate* pool config; ``num_blocks`` is the total
            across shards and must divide evenly.
          n_shards: shard count; ``None`` discovers it from ``mesh`` (or
            the ambient ``sharding.context.current_mesh()``) via
            ``sharding.rules.pool_shard_count`` — 1 without a mesh.
          mesh: optional explicit mesh for discovery
            (``launch.mesh.Mesh``).
        """
        n_shards = discover_shards(n_shards, mesh)
        assert n_shards >= 1
        assert cfg.num_blocks % n_shards == 0, \
            (f"num_blocks {cfg.num_blocks} must divide evenly across "
             f"{n_shards} shards")
        self.cfg = cfg
        self.n_shards = n_shards
        self.shard_blocks = cfg.num_blocks // n_shards
        shard_cfg = dataclasses.replace(cfg, num_blocks=self.shard_blocks)
        self.shards = [BlockPool(shard_cfg) for _ in range(n_shards)]
        # offered-but-not-yet-routed aggregate reservations (phase 1)
        self._pending = 0
        # routed requests: rid -> shard, rid -> outstanding reserved blocks
        self._rid_shard: dict[int, int] = {}
        self._rid_reserved: dict[int, int] = {}
        # sticky prefix-page affinity: page hash -> last routed shard
        # (LRU-bounded at PAGE_AFFINITY_CAP — unlike the rid maps, pages
        # have no release event to clean up on)
        self._page_shard: dict[str, int] = {}
        self.obs = None          # telemetry hook (obs.Observer.attach)

    # -- aggregate capacity (scheduler/engine-facing) -----------------------

    @property
    def num_free(self) -> int:
        return sum(s.num_free for s in self.shards)

    @property
    def num_cached(self) -> int:
        return sum(s.num_cached for s in self.shards)

    @property
    def num_live(self) -> int:
        return sum(s.num_live for s in self.shards)

    @property
    def reserved(self) -> int:
        """Outstanding reservations: unrouted (pending) + routed (shard)."""
        return self._pending + sum(s.reserved for s in self.shards)

    @property
    def stats(self) -> PoolStats:
        """Aggregated per-shard counters (a fresh snapshot per read)."""
        agg = PoolStats()
        names = agg.fields()
        for s in self.shards:
            for f in names:
                setattr(agg, f, getattr(agg, f) + getattr(s.stats, f))
        return agg

    @property
    def k_pages(self):
        """Non-None iff the shard pools carry KV buffers (shard 0's)."""
        return self.shards[0].k_pages

    @property
    def v_pages(self):
        return self.shards[0].v_pages

    # -- two-phase admission reservations -----------------------------------

    def can_reserve(self, n: int) -> bool:
        """Admission check: aggregate headroom covers ``n`` more blocks AND
        the request could ever fit on a single shard (a sequence and its
        CoW forks never span shards)."""
        if n > self.shard_blocks:
            return False
        headroom = sum(s.num_free + s.num_cached - s.reserved
                       for s in self.shards)
        return headroom - self._pending >= n

    def reserve(self, n: int) -> None:
        """Phase 1 (offer time): book ``n`` blocks against the aggregate
        pool; no shard is chosen yet."""
        self._pending += n

    def cancel_pending(self, n: int) -> None:
        """Give up an aggregate (phase-1) booking that was never routed —
        the backpressure path for callers that reserved but then dropped
        the request instead of waiting for a shard to free."""
        assert n <= self._pending, (n, self._pending)
        self._pending -= n

    def route(self, rid: int, page: str, n: int,
              tier_hint: Optional[int] = None) -> Optional[int]:
        """Phase 2 (schedule time): commit request ``rid``'s pending
        reservation of ``n`` blocks to a shard.

        Shard choice: the sticky ``page`` affinity shard if it still has
        headroom (shared prefixes co-locate); else ``tier_hint`` — the
        shard whose *spill tiers* hold the request's prefix (a promotable
        lower-tier hit, stamped by ``MarsScheduler.tier_probe``), so
        landing there turns a recompute into a shard-local promotion;
        else the least-loaded shard (live + reserved blocks) that can
        hold ``n``.  Returns the shard id, or ``None`` when no shard
        currently has headroom — the caller leaves the request queued
        and retries after sequences finish.
        """
        assert n <= self._pending, (n, self._pending)
        s = self._page_shard.get(page)
        if s is None or not self.shards[s].can_reserve(n):
            if tier_hint is not None \
                    and self.shards[tier_hint].can_reserve(n):
                s = tier_hint
            else:
                # rank shards off the shared load snapshot — same numbers
                # the obs gauges publish (headroom == can_reserve, load ==
                # live + reserved), so routing and telemetry never disagree
                fits = [r for r in shard_load_snapshot(self)
                        if r["headroom"] >= n]
                if not fits:
                    return None
                s = min(fits, key=lambda r: (r["load"], r["shard"]))["shard"]
        self._pending -= n
        self.shards[s].reserve(n)
        # refresh LRU position, then trim the oldest entry past the cap
        self._page_shard.pop(page, None)
        self._page_shard[page] = s
        if len(self._page_shard) > PAGE_AFFINITY_CAP:
            self._page_shard.pop(next(iter(self._page_shard)))
        if n > 0:      # a zero-block request needs no release bookkeeping
            self._rid_shard[rid] = s
            self._rid_reserved[rid] = self._rid_reserved.get(rid, 0) + n
        return s

    def unreserve(self, n: int, rid: int) -> None:
        """Release ``n`` of routed request ``rid``'s shard reservation (the
        engine converts reservations into real allocations as sequences
        grow, and releases the remainder when the request finishes)."""
        if n == 0:
            return
        s = self._rid_shard[rid]
        assert n <= self._rid_reserved[rid], (n, self._rid_reserved[rid])
        self.shards[s].unreserve(n)
        self._rid_reserved[rid] -= n
        if self._rid_reserved[rid] == 0:
            del self._rid_reserved[rid]
            del self._rid_shard[rid]

    def shard_of(self, rid: int) -> Optional[int]:
        """Shard a routed request was committed to (None once released)."""
        return self._rid_shard.get(rid)

    def load(self, shard: int) -> int:
        """Routing load metric for one shard: live + reserved blocks."""
        s = self.shards[shard]
        return s.num_live + s.reserved

    def least_loaded(self) -> int:
        """Shard with the lowest load (ties -> lowest index); the routing
        fallback when no prefix-page affinity applies."""
        return min(shard_load_snapshot(self),
                   key=lambda r: (r["load"], r["shard"]))["shard"]

    # -- invariants ----------------------------------------------------------

    def check_invariants(self, incremental: bool = False) -> None:
        """Per-shard allocator ground truth plus reservation accounting.
        ``incremental`` forwards to each shard's O(dirty) sweep (the
        cross-shard reservation accounting below is O(live rids) either
        way)."""
        for s in self.shards:
            s.check_invariants(incremental=incremental)
        assert self._pending >= 0
        assert all(v > 0 for v in self._rid_reserved.values())
        assert set(self._rid_reserved) == set(self._rid_shard)
        for rid, s in self._rid_shard.items():
            assert 0 <= s < self.n_shards, (rid, s)
        # every routed reservation is backed by its shard's counter
        per_shard: dict[int, int] = {}
        for rid, n in self._rid_reserved.items():
            s = self._rid_shard[rid]
            per_shard[s] = per_shard.get(s, 0) + n
        for i, s in enumerate(self.shards):
            assert s.reserved == per_shard.get(i, 0), \
                (i, s.reserved, per_shard.get(i, 0))
