"""Tiered KV memory: host / mock-remote spill tiers behind ``BlockPool``
(port of ``repro/kvcache/tiers.py``).

The pool is a single fixed-capacity tier.  This module turns eviction
into *demotion*: when memory pressure reclaims a registered prefix
block, its KV payload moves to a slower tier (host memory, then a mock
"remote" store with a latency/bandwidth model) instead of vanishing.  A
later prefix-cache miss that hits a lower tier *promotes* the blocks
back.

Promotions accumulate in a lookahead queue over a batched prefill
(``TierManager.match`` enqueues, the owning backend flushes once per
batch) and the batched copy-in is MARS-reordered by **destination row
group** — groups in first-arrival order, FIFO within a group
(``promotion_order``, the list rendering of ``core.reorder.mars_order``).

Eviction can be cost-aware (``EvictionPolicy(mode="cost")``): victims
are ranked by what re-acquiring the block would cost — 0 for a block
whose clean copy already sits in a tier, ``bytes / tier bandwidth +
latency`` for a demotable block, ``tokens-to-recompute x prefill cost``
for one the cascade would drop.  ``TierManager`` installs the scoring
hook on pools configured with ``eviction="cost"``.

Tier payloads are CPU torch tensors, **copies** of the pool slot taken
at demotion (``.clone()``: indexing the pool gives a view of the slot
that is being freed), so the pool slot → tier entry → ``write_kv`` into
the promoted slot chain is a bit copy for every pool dtype, fp8
included.  ``TierStats.stall_us`` is the *modelled* fetch cost
(``TierSpec.fetch_us``), never a measured time.  With an
``obs.Observer`` attached, demotions, promotions and each batch's
modelled stall are trace events (``tier.demote``/``promote``/
``stall``), and each promotion batch's write stream feeds the modelled
``tier.promote_row_hit_pct`` gauge.

>>> from repro_torch.kvcache.pool import BlockPool, PoolConfig
>>> from repro_torch.kvcache.prefix import BlockTable, PrefixCache
>>> pool = BlockPool(PoolConfig(num_blocks=4, block_size=2,
...                             n_kv_heads=1, head_dim=2))
>>> cache = PrefixCache(2); cache.attach(pool)
>>> tiers = TierManager(pool, cache)
>>> t = BlockTable()
>>> t.extend(pool, [1, 2, 3, 4], seq_tokens=[1, 2, 3, 4], cache=cache)
>>> cache.release(t, pool)              # blocks linger as evictable cache
>>> _ = pool.alloc(4)                   # pressure: eviction demotes
>>> tiers.tiers[0].holds((1, 2)), pool.num_cached
(True, 0)
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kvcache.placement import row_group_of
from repro_torch.kvcache.pool import BlockPool, LINES_PER_BLOCK
from repro_torch.kvcache.prefix import PrefixCache
from repro_torch.obs.metrics import StatGroup

# recompute cost model for cost-aware eviction: microseconds of prefill
# per token that would have to be re-run to rebuild a dropped prefix
# block (depth tokens — prefill is causal, the whole prefix reruns).
# Only the ratio against TierSpec fetch costs matters.
PREFILL_US_PER_TOKEN = 25.0


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One spill tier's capacity + fetch-cost model.

    ``fetch_us`` is the modelled stall of pulling ``n_bytes`` up from
    this tier in one batch: a flat per-batch ``latency_us`` plus the
    transfer at ``gbps`` sustained bandwidth.
    """

    name: str
    capacity_blocks: int          # entries held; <= 0 means unbounded
    latency_us: float = 0.0       # per-batch fetch latency
    gbps: float = 10.0            # sustained fetch bandwidth

    def fetch_us(self, n_bytes: int) -> float:
        # GB/s == bytes/ns: n_bytes / (gbps * 1000) is microseconds
        return self.latency_us + n_bytes / (self.gbps * 1e3)


def default_tiers(num_blocks: int) -> tuple[TierSpec, ...]:
    """Host DRAM behind the pool, a mock remote store behind that, sized
    relative to the pool (4x and 32x its blocks)."""
    return (TierSpec("host", 4 * num_blocks, latency_us=5.0, gbps=20.0),
            TierSpec("remote", 32 * num_blocks, latency_us=200.0, gbps=2.0))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class TierEntry:
    """A demoted block: the prefix it completes + its captured payload."""

    key: tuple                    # full-token prefix (PrefixCache key)
    content: tuple                # the block's own token span (pool tag)
    k: torch.Tensor               # (n_layers, block_size, Hkv, dh) copy
    v: torch.Tensor

    @property
    def depth(self) -> int:
        """Tokens a from-scratch recompute of this block would prefill."""
        return len(self.key)

    @property
    def nbytes(self) -> int:
        return _nbytes(self.k) + _nbytes(self.v)


class SpillTier:
    """One LRU-ordered tier of demoted block payloads, keyed by prefix."""

    def __init__(self, spec: TierSpec):
        self.spec = spec
        self._entries: "OrderedDict[tuple, TierEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def holds(self, key: tuple) -> bool:
        return key in self._entries

    def get(self, key: tuple) -> Optional[TierEntry]:
        """Fetch (and LRU-refresh) an entry; None on miss."""
        e = self._entries.get(key)
        if e is not None:
            self._entries.move_to_end(key)
        return e

    def put(self, entry: TierEntry) -> list[TierEntry]:
        """Insert an entry, returning whatever overflowed (oldest first)
        for the caller to cascade into the next tier (or drop)."""
        self._entries.pop(entry.key, None)
        self._entries[entry.key] = entry
        out: list[TierEntry] = []
        cap = self.spec.capacity_blocks
        while cap > 0 and len(self._entries) > cap:
            _, old = self._entries.popitem(last=False)
            out.append(old)
        return out

    @property
    def occupancy(self) -> float:
        cap = self.spec.capacity_blocks
        return len(self._entries) / cap if cap > 0 else 0.0

    @property
    def nbytes(self) -> int:
        """Payload bytes the tier holds."""
        return sum(e.nbytes for e in self._entries.values())


class TierStats(StatGroup):
    """Tier-boundary counters (``obs.metrics.StatGroup`` facade).
    ``stall_us`` is the modelled fetch stall (``TierSpec.fetch_us``)."""
    FIELDS = {"demotes": 0, "promotes": 0, "promoted_tokens": 0,
              "refetched_bytes": 0, "drops": 0, "clean_drops": 0,
              "stall_us": 0.0}


def promotion_order(group_ids: Sequence[int]) -> list[int]:
    """MARS emission order for a promotion batch, keyed by destination
    row group: writes grouped by row group, groups in first-arrival
    order, FIFO within a group.

    >>> promotion_order([3, 1, 3, 1, 2])
    [0, 2, 1, 3, 4]
    """
    first: dict[int, int] = {}
    for i, g in enumerate(group_ids):
        first.setdefault(g, i)
    return sorted(range(len(group_ids)),
                  key=lambda i: (first[group_ids[i]], i))


def _key_tag(key: tuple) -> str:
    """Short stable hash of a prefix key for trace events."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


class TierManager:
    """Demote-on-evict / promote-on-miss glue between one ``BlockPool``,
    its ``PrefixCache``, and a cascade of ``SpillTier``s.

    Shard-local by construction: a manager owns exactly one pool (a
    sharded backend builds one manager per shard pool), so demoted
    payloads never cross shards.

    Wiring: interposes on ``pool.on_evict`` (chaining to whatever was
    installed — normally ``PrefixCache.on_evict``) so eviction of a
    registered block captures its payload *before* the prefix cache
    unregisters it and the pool frees the slot, and drops the block's
    pending dirty state (``pool.forget_dirty``): the captured copy is the
    freshest payload, the host tensors being the source of truth.

    Promotion protocol (what ``PagedBackend`` drives):

      1. ``match(prompt)`` — prefix-cache match first; each further
         full-block miss that hits a tier allocates a MARS-placed
         destination block and *enqueues* the copy-in (a second row
         wanting the same pending key references the queued block).
      2. ``flush_promotions()`` — once per batch: reorder the queue by
         destination row group, copy in through ``pool.write_kv`` (which
         marks the blocks dirty, so the backend's mirror re-uploads them
         before the next decode step), register the prefixes, and charge
         the modelled fetch stall.
      3. ``cancel_promotions()`` — rollback path: forget the queue
         without copying (the destination blocks are released by the
         caller's table rollback; tier entries were never removed).
    """

    def __init__(self, pool: BlockPool, prefix: PrefixCache,
                 specs: Optional[Sequence[TierSpec]] = None, *,
                 reorder: bool = True):
        self.pool = pool
        self.prefix = prefix
        self.tiers = [SpillTier(s) for s in
                      (specs if specs is not None
                       else default_tiers(pool.cfg.num_blocks))]
        assert self.tiers, "need at least one spill tier"
        self.reorder = reorder
        self.stats = TierStats()
        self.obs = None           # telemetry hook (obs.Observer.attach)
        self.obs_shard = 0
        # lookahead promotion queue: (dst block id, entry, tier index)
        self._pending: list[tuple[int, TierEntry, int]] = []
        self._pending_by_key: dict[tuple, int] = {}
        # interpose on eviction, chaining to the prefix cache's hook
        self._chain = pool.on_evict
        pool.on_evict = self._on_evict
        # cost-aware eviction: install the scoring hook when configured
        if pool.eviction.mode == "cost":
            pool.eviction.cost_fn = self.evict_cost

    # -- demotion (the eviction path) ---------------------------------------

    def _on_evict(self, bid: int) -> None:
        key = self.prefix._by_bid.get(bid)
        if key is not None:
            self._demote(bid, key)
        # the pending payload of an evicted block must not be re-staged:
        # the demotion above captured the freshest copy; the slot is free
        self.pool.forget_dirty(bid)
        if self._chain is not None:
            self._chain(bid)       # prefix cache unregisters the block
        self._publish()

    def _demote(self, bid: int, key: tuple) -> None:
        for t in self.tiers:
            if t.holds(key):
                # registered full blocks are immutable once complete, so
                # a resident tier copy is clean — dropping is free
                t.get(key)                 # LRU refresh
                self.stats.clean_drops += 1
                return
        pool = self.pool
        # bookkeeping-only pools (no KV buffers) demote placement state
        # alone; a KV pool's slot is cloned, never viewed (it is freed
        # and reused right after this)
        entry = TierEntry(
            key=key, content=pool.content[bid],
            k=pool.k_pages[:, bid].clone()
            if pool.k_pages is not None else torch.zeros(0),
            v=pool.v_pages[:, bid].clone()
            if pool.v_pages is not None else torch.zeros(0))
        self.stats.demotes += 1
        if self.obs is not None:
            self.obs.trace.event("tier.demote", key=_key_tag(key),
                                 shard=self.obs_shard,
                                 tier=self.tiers[0].spec.name)
        self._cascade(entry, 0)

    def _cascade(self, entry: TierEntry, level: int) -> None:
        """Insert at ``level``; overflow demotes down the cascade, and
        overflow past the last tier is dropped (counted)."""
        for displaced in self.tiers[level].put(entry):
            if level + 1 < len(self.tiers):
                self._cascade(displaced, level + 1)
            else:
                self.stats.drops += 1

    # -- promotion (the miss path) ------------------------------------------

    def _lookup(self, key: tuple) -> tuple[Optional[TierEntry], int]:
        for i, t in enumerate(self.tiers):
            e = t.get(key)
            if e is not None:
                return e, i
        return None, -1

    def holds_prefix(self, prompt: Sequence[int]) -> bool:
        """True iff the first full prompt block is promotable from a
        tier — what shard routing counts as a lower-tier prefix hit."""
        bs = self.prefix.block_size
        if len(prompt) <= bs:
            return False
        key = tuple(prompt[:bs])
        return any(t.holds(key) for t in self.tiers)

    def match(self, prompt: Sequence[int]) -> tuple[list[int], int]:
        """``PrefixCache.match`` extended one level down: after the
        in-pool chain ends, keep walking full blocks through the tiers,
        enqueueing a promotion per hit.  Returned blocks are referenced
        (pending destinations included); queued copy-ins land at the next
        ``flush_promotions``.  Never raises on pool pressure — a
        promotion that cannot get a destination block stops the chain
        (the tokens are recomputed instead)."""
        pool = self.pool
        bids, n = self.prefix.match(prompt, pool)
        bs = self.prefix.block_size
        while n + bs < len(prompt):
            key = tuple(prompt[:n + bs])
            dst = self._pending_by_key.get(key)
            if dst is not None:      # another row already queued this key
                pool.incref(dst)
                pool.stats.prefix_hits += 1
                bids.append(dst)
                n += bs
                continue
            entry, level = self._lookup(key)
            if entry is None:
                break
            try:
                dst = pool.alloc(1, hint_blocks=bids)[0]
            except RuntimeError:
                break                # no room to promote: recompute
            pool.content[dst] = entry.content
            self._pending.append((dst, entry, level))
            self._pending_by_key[key] = dst
            pool.stats.prefix_hits += 1
            bids.append(dst)
            n += bs
        return bids, n

    @property
    def pending(self) -> int:
        """Queued promotions awaiting ``flush_promotions``."""
        return len(self._pending)

    def flush_promotions(self) -> list[int]:
        """Drain the lookahead queue as one batched copy-in, MARS-ordered
        by destination row group.  Returns the destination block ids in
        copy order.  Promoted blocks are marked dirty and their prefixes
        register in the cache.  Tier entries stay resident (inclusive
        cache: a later eviction of the promoted block is a free
        clean-drop)."""
        if not self._pending:
            return []
        pend, self._pending = self._pending, []
        self._pending_by_key.clear()
        pool, bpg = self.pool, self.pool.cfg.blocks_per_group
        order = promotion_order([row_group_of(d, bpg)
                                 for d, _, _ in pend]) \
            if self.reorder else range(len(pend))
        dsts: list[int] = []
        tier_bytes: dict[int, int] = {}
        for i in order:
            dst, entry, level = pend[i]
            if pool.k_pages is not None:
                # full-block copy-in through the write path, so the
                # dirty-staging contract marks dst for the mirror
                pool.write_kv(dst, 0, entry.k, entry.v)
            self.prefix.register(entry.key, dst, pool)
            tier_bytes[level] = tier_bytes.get(level, 0) + entry.nbytes
            self.stats.promotes += 1
            self.stats.promoted_tokens += len(entry.content)
            self.stats.refetched_bytes += entry.nbytes
            dsts.append(dst)
            if self.obs is not None:
                self.obs.trace.event("tier.promote", key=_key_tag(entry.key),
                                     shard=self.obs_shard, dst=dst,
                                     tier=self.tiers[level].spec.name)
        stall = sum(self.tiers[lv].spec.fetch_us(nb)
                    for lv, nb in tier_bytes.items())
        self.stats.stall_us += stall
        if self.obs is not None:
            self.obs.trace.event("tier.stall", shard=self.obs_shard,
                                 blocks=len(dsts),
                                 us=round(stall, 3))
            self.obs.observe_promotion(self.obs_shard,
                                       self.write_trace(dsts))
        self._publish()
        return dsts

    def cancel_promotions(self) -> None:
        """Forget the queue without copying (prefill rollback: the
        destination blocks are being released by the caller, the tier
        entries were never removed)."""
        self._pending.clear()
        self._pending_by_key.clear()

    @staticmethod
    def write_trace(dsts: Sequence[int], chunk_lines: int = 8,
                    queue_depth: int = 4) -> np.ndarray:
        """64B-line write addresses of a promotion copy-in stream: each
        destination block is one DMA descriptor issued in
        ``chunk_lines``-line bursts, with ``queue_depth`` descriptors in
        flight and the bus round-robining among them, so the submission
        order ``flush_promotions`` reorders decides bank/row behaviour."""
        if not len(dsts):
            return np.zeros(0, np.int64)
        queue = [[int(d) * LINES_PER_BLOCK, LINES_PER_BLOCK]
                 for d in dsts]
        inflight: list[list[int]] = []
        out: list[np.ndarray] = []
        i = 0
        while inflight or i < len(queue):
            while len(inflight) < queue_depth and i < len(queue):
                inflight.append(queue[i])
                i += 1
            d = inflight.pop(0)
            n = min(chunk_lines, d[1])
            out.append(np.arange(d[0], d[0] + n, dtype=np.int64))
            d[0] += n
            d[1] -= n
            if d[1]:
                inflight.append(d)
        return np.concatenate(out)

    # -- cost-aware eviction -------------------------------------------------

    def evict_cost(self, bid: int) -> float:
        """Re-acquisition cost (microseconds) of evicting ``bid`` now:
        0 when a clean copy already sits in a tier, the first tier's
        fetch cost when demotion would keep it refetchable, the causal
        recompute cost (prefix depth x prefill cost) when the cascade
        would drop it."""
        key = self.prefix._by_bid.get(bid)
        if key is None:
            return 0.0               # unregistered: nothing to refetch
        if any(t.holds(key) for t in self.tiers):
            return 0.0               # clean copy below: drop is free
        nbytes = 0
        if self.pool.k_pages is not None:
            nbytes = _nbytes(self.pool.k_pages[:, bid]) * 2
        cap = sum(max(t.spec.capacity_blocks, 0) for t in self.tiers)
        held = sum(len(t) for t in self.tiers)
        if any(t.spec.capacity_blocks <= 0 for t in self.tiers) \
                or held < cap:
            return self.tiers[0].spec.fetch_us(nbytes)
        return len(key) * PREFILL_US_PER_TOKEN

    # -- telemetry / invariants ----------------------------------------------

    def _publish(self) -> None:
        if self.obs is None:
            return
        reg = self.obs.registry
        for t in self.tiers:
            stem = f"tier.shard{self.obs_shard}.{t.spec.name}"
            reg.set(f"{stem}.blocks", len(t))
            reg.set(f"{stem}.occupancy", t.occupancy)

    def check(self) -> None:
        """Tier-layer ground truth: pending destinations are live and
        mutually consistent, no key is resident in two tiers, every tier
        respects its capacity."""
        pool = self.pool
        assert len(self._pending) == len(self._pending_by_key)
        for dst, entry, level in self._pending:
            assert pool.used[dst] and pool.refcount[dst] >= 1, dst
            assert self._pending_by_key[entry.key] == dst
            assert 0 <= level < len(self.tiers)
        seen: set[tuple] = set()
        for t in self.tiers:
            keys = set(t._entries)
            assert not (keys & seen), "key resident in two tiers"
            seen |= keys
            cap = t.spec.capacity_blocks
            assert cap <= 0 or len(t) <= cap, (t.spec.name, len(t), cap)
            for key, e in t._entries.items():
                assert e.key == key
                assert len(e.content) == pool.cfg.block_size
