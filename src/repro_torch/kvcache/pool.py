"""Fixed-capacity block pool: a slab allocator over a preallocated KV buffer
(port of ``repro/kvcache/pool.py``).

Bookkeeping mirrors the fixed-array style of the MARS engine: an
occupancy bit-vector (``used``), a refcount array, and first-arrival /
last-use ticks per block — numpy, bitwise the reference's.  The physical
KV storage is a pair of CPU torch tensors of shape ``(n_layers,
num_blocks, block_size, n_kv_heads, head_dim)`` in the cache dtype,
allocated once up front and mutated in place; a backend on a CUDA device
pins them (``pin_memory``) and stages dirty blocks to its device mirror.
Block ids index directly into the paged-attention kernel's
``k_pages``/``v_pages`` operands.

Blocks move through three states::

    free  --alloc-->  live (refcount >= 1)
    live  --decref(cache=True), refcount hits 0-->  cached (evictable)
    live  --decref(cache=False), refcount hits 0--> free
    cached --reuse--> live        cached --evict--> free

>>> pool = BlockPool(PoolConfig(num_blocks=8, block_size=4))
>>> a = pool.alloc(2)
>>> pool.num_live, pool.num_free, pool.num_cached
(2, 6, 0)
>>> pool.decref(a[0])                 # free outright
>>> pool.decref(a[1], cache=True)     # retain as evictable prefix storage
>>> pool.num_live, pool.num_free, pool.num_cached
(0, 7, 1)
>>> pool.check_invariants()
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.kvcache.evict import EvictionPolicy
from repro_torch.kvcache.placement import PlacementPolicy, row_group_of
from repro_torch.models.config import torch_dtype
from repro_torch.obs.metrics import StatGroup

# one block == one 4KB page of the DRAM model (64 x 64B lines)
LINES_PER_BLOCK = 64


def as_cpu_tensor(x) -> torch.Tensor:
    """KV payload (torch tensor or numpy array, bfloat16 numpy included)
    as a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    from repro_torch.convert import tensor_from_numpy
    return tensor_from_numpy(np.asarray(x))


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    num_blocks: int = 256
    block_size: int = 16          # tokens per block
    blocks_per_group: int = 8     # DRAM row neighborhood = n_banks pages
    placement: str = "mars"       # "mars" | "naive"
    eviction: str = "fifo"        # "fifo" (PhyPageOrderQ) | "lru" | "cost"
    # KV buffer shape; None = metadata-only pool (simulation / tests)
    n_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None
    n_layers: int = 1             # leading layer axis of the KV buffer
    dtype: str = "float32"


class PoolStats(StatGroup):
    """Allocator counters (``obs.metrics.StatGroup`` facade)."""
    FIELDS = {"allocs": 0, "frees": 0, "evictions": 0, "cow_copies": 0,
              "prefix_hits": 0, "alloc_fails": 0}


class BlockPool:
    def __init__(self, cfg: PoolConfig):
        self.cfg = cfg
        n = cfg.num_blocks
        self.used = np.zeros(n, bool)            # occupancy bit-vector
        self.refcount = np.zeros(n, np.int32)
        self.arrival = np.zeros(n, np.int64)     # allocation tick
        self.last_use = np.zeros(n, np.int64)
        self.content: list[object] = [None] * n
        self._tick = 0
        self.placement = PlacementPolicy(n, cfg.blocks_per_group,
                                         cfg.placement)
        self.eviction = EvictionPolicy(cfg.eviction)
        # cached (refcount-0, still resident) blocks, insertion-ordered
        self._evictable: dict[int, None] = {}
        # prefix cache hook: called with a block id as it is evicted
        self.on_evict: Optional[Callable[[int], None]] = None
        # admission reservations (see reserve()): blocks promised to
        # admitted-but-not-yet-allocated work
        self.reserved = 0
        # telemetry (obs.Observer.attach): None = uninstrumented; events
        # carry obs_shard so sharded pools tag their shard index
        self.obs = None
        self.obs_shard = 0
        self.stats = PoolStats()
        # blocks whose allocator state changed since the last incremental
        # invariant sweep (check_invariants(incremental=True))
        self._meta_dirty: set[int] = set()
        # KV payload: host-resident CPU tensors, mutated in place
        self.k_pages = self.v_pages = None
        # blocks whose payload changed since the last drain_dirty()
        self.dirty: set[int] = set()
        if cfg.n_kv_heads is not None and cfg.head_dim is not None:
            shape = (cfg.n_layers, n, cfg.block_size,
                     cfg.n_kv_heads, cfg.head_dim)
            self.k_pages = torch.zeros(shape, dtype=torch_dtype(cfg.dtype))
            self.v_pages = torch.zeros(shape, dtype=torch_dtype(cfg.dtype))

    def pin_memory(self) -> None:
        """Move the KV buffers into page-locked host memory (once), so
        staging copies to a CUDA device run asynchronously.  The copy
        keeps every value, so the dirty set stays exact."""
        if self.k_pages is not None and not self.k_pages.is_pinned():
            self.k_pages = self.k_pages.pin_memory()  # lint: ok(pool-kv-mutation)
            self.v_pages = self.v_pages.pin_memory()  # lint: ok(pool-kv-mutation)

    # -- capacity -----------------------------------------------------------

    @property
    def num_free(self) -> int:
        return self.placement.num_free

    @property
    def num_cached(self) -> int:
        return len(self._evictable)

    @property
    def num_live(self) -> int:
        return int(self.used.sum()) - self.num_cached

    def can_alloc(self, n: int) -> bool:
        """True iff ``alloc(n)`` would succeed right now (free blocks plus
        cached blocks reclaimable by eviction); ignores reservations."""
        return self.num_free + self.num_cached >= n

    # -- admission reservations ---------------------------------------------

    def can_reserve(self, n: int) -> bool:
        """Could ``n`` more blocks be promised on top of every outstanding
        reservation?  (free + cached − reserved ≥ n.)"""
        return self.num_free + self.num_cached - self.reserved >= n

    def reserve(self, n: int) -> None:
        """Promise ``n`` blocks to admitted-but-not-yet-allocated work."""
        self.reserved += n
        if self.obs is not None:
            self.obs.trace.event("pool.reserve", n=n, shard=self.obs_shard)

    def unreserve(self, n: int) -> None:
        """Release ``n`` previously reserved blocks (n ≤ reserved)."""
        assert n <= self.reserved, (n, self.reserved)
        self.reserved -= n
        if self.obs is not None:
            self.obs.trace.event("pool.unreserve", n=n,
                                 shard=self.obs_shard)

    # -- alloc / ref / free -------------------------------------------------

    def alloc(self, n: int = 1,
              hint_blocks: Iterable[int] = ()) -> list[int]:
        """Allocate ``n`` blocks at refcount 1 (evicting cached blocks when
        the free list is short; MARS placement near ``hint_blocks``).
        Raises RuntimeError("pool exhausted ...") if free + cached < n;
        the pool is unchanged in that case."""
        short = n - self.num_free
        if short > 0:
            if short > self.num_cached:
                self.stats.alloc_fails += 1
                if self.obs is not None:
                    self.obs.trace.event("pool.alloc_fail", n=n,
                                         shard=self.obs_shard)
                raise RuntimeError(
                    f"pool exhausted: want {n}, free {self.num_free}, "
                    f"cached {self.num_cached}")
            self._evict(short)
        hint_groups = self.placement.groups_of(list(hint_blocks))
        out = self.placement.choose(n, hint_groups)
        assert out is not None
        self._tick += 1
        for bid in out:
            self.used[bid] = True
            self.refcount[bid] = 1
            self.arrival[bid] = self._tick
            self.last_use[bid] = self._tick
            self.content[bid] = None
        self.stats.allocs += n
        self._meta_dirty.update(out)
        if self.obs is not None:
            self.obs.trace.event("pool.alloc", n=n, shard=self.obs_shard)
        return out

    def incref(self, bid: int) -> None:
        assert self.used[bid] and self.refcount[bid] > 0
        self.refcount[bid] += 1

    def decref(self, bid: int, cache: bool = False) -> None:
        """Drop one reference; at zero either retain as evictable prefix
        storage (``cache=True``) or free outright."""
        assert self.used[bid] and self.refcount[bid] > 0, bid
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            if cache:
                self._evictable[bid] = None
                self._meta_dirty.add(bid)
            else:
                self._free_block(bid)

    def reuse_cached(self, bid: int) -> None:
        """Revive a cached block (prefix hit): refcount 0 -> 1."""
        assert bid in self._evictable, bid
        del self._evictable[bid]
        self.refcount[bid] = 1
        self._tick += 1
        self.last_use[bid] = self._tick
        self.stats.prefix_hits += 1
        self._meta_dirty.add(bid)

    def touch(self, bid: int) -> None:
        self._tick += 1
        self.last_use[bid] = self._tick

    def _free_block(self, bid: int) -> None:
        self.used[bid] = False
        self.refcount[bid] = 0
        self.content[bid] = None
        # a freed id must not linger in the dirty set: the drain consumer
        # would re-stage a dead slot after the slot is reused
        self.dirty.discard(bid)
        self.placement.add_free(bid)
        self.stats.frees += 1
        self._meta_dirty.add(bid)

    def _evict(self, n: int) -> None:
        victims = self.eviction.select(self._evictable, self.arrival,
                                       self.last_use, n)
        for bid in victims:
            del self._evictable[bid]
            if self.on_evict is not None:
                self.on_evict(bid)
            self._free_block(bid)
            self.stats.evictions += 1
        if victims and self.obs is not None:
            self.obs.trace.event("pool.evict", n=len(victims),
                                 shard=self.obs_shard)

    # -- KV payload ---------------------------------------------------------

    def write_kv(self, bid: int, offset: int, k, v) -> None:
        """Write ``t`` token KV rows into a block at ``offset``, for every
        layer plane at once, and mark the block dirty for staging.

        k, v: (n_layers, t, n_kv_heads, head_dim) — torch tensors or numpy
        arrays; a layerless (t, n_kv_heads, head_dim) is accepted when the
        pool has a single layer plane.
        """
        k, v = as_cpu_tensor(k), as_cpu_tensor(v)
        if k.dim() == 3:
            assert self.cfg.n_layers == 1, "layered pool needs layered KV"
            k, v = k[None], v[None]
        t = k.shape[1]
        assert offset + t <= self.cfg.block_size
        self.k_pages[:, bid, offset:offset + t] = k
        self.v_pages[:, bid, offset:offset + t] = v
        self.dirty.add(bid)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write payload copy (content tag + all layer planes)."""
        self.content[dst] = self.content[src]
        if self.k_pages is not None:
            self.k_pages[:, dst] = self.k_pages[:, src]
            self.v_pages[:, dst] = self.v_pages[:, src]
            self.dirty.add(dst)
        self.stats.cow_copies += 1
        if self.obs is not None:
            self.obs.trace.event("pool.cow", src=src, dst=dst,
                                 shard=self.obs_shard)

    def forget_dirty(self, bid: int) -> None:
        """Drop a block from the dirty-staging set without draining, for
        an owner that invalidates the block's pending payload out of band
        (``kvcache.tiers.TierManager`` capturing a demoted block's KV
        before the slot is reused)."""
        self.dirty.discard(bid)

    def drain_dirty(self) -> list[int]:
        """Block ids whose payload changed since the last drain (sorted),
        clearing the set.  A single consumer — the owning backend's
        device mirror — drains once per decode step and re-uploads
        exactly those blocks."""
        out = sorted(self.dirty)
        self.dirty.clear()
        if out and self.obs is not None:
            self.obs.trace.event("pool.drain_dirty", n=len(out),
                                 shard=self.obs_shard)
        return out

    # -- invariants ---------------------------------------------------------

    def check_invariants(self, incremental: bool = False) -> None:
        """Allocator ground truth; raises AssertionError on the first
        violation.  ``incremental=False`` is the exhaustive O(num_blocks)
        sweep; ``incremental=True`` checks only the blocks whose allocator
        state changed since the previous incremental sweep, plus O(1)
        aggregate counts."""
        if incremental:
            self._check_incremental()
            return
        free = self.placement.free_ids()
        assert len(free) == len(set(free)), "free list holds duplicates"
        free_set = set(free)
        group_union = set().union(*self.placement._group_free) \
            if self.placement._group_free else set()
        assert free_set == group_union, "stack / group free sets diverged"
        for bid in range(self.cfg.num_blocks):
            if bid in free_set:
                assert not self.used[bid], f"block {bid} free AND used"
                assert self.refcount[bid] == 0
            else:
                assert self.used[bid], f"block {bid} leaked (not free, not used)"
        cached = set(self._evictable)
        for bid in cached:
            assert self.used[bid] and self.refcount[bid] == 0
        live = [b for b in range(self.cfg.num_blocks)
                if self.used[b] and b not in cached]
        for bid in live:
            assert self.refcount[bid] > 0, f"live block {bid} has refcount 0"
        assert len(free_set) + len(cached) + len(live) == self.cfg.num_blocks
        assert 0 <= self.reserved <= self.cfg.num_blocks
        self._meta_dirty.clear()   # full sweep subsumes the pending one

    def _check_incremental(self) -> None:
        """O(dirty) slice of the invariant sweep: aggregate accounting plus
        per-block state for every block touched since the last sweep."""
        n = self.cfg.num_blocks
        n_used = int(self.used.sum())
        assert self.num_free + n_used == n, \
            (self.num_free, n_used, "free/used partition lost blocks")
        assert self.num_cached <= n_used, (self.num_cached, n_used)
        assert 0 <= self.reserved <= n, self.reserved
        bpg = self.placement.blocks_per_group
        for bid in self._meta_dirty:
            in_free = bid in \
                self.placement._group_free[row_group_of(bid, bpg)]
            if in_free:
                assert not self.used[bid], f"block {bid} free AND used"
                assert self.refcount[bid] == 0, bid
            else:
                assert self.used[bid], \
                    f"block {bid} leaked (not free, not used)"
                if bid in self._evictable:
                    assert self.refcount[bid] == 0, bid
                else:
                    assert self.refcount[bid] > 0, \
                        f"live block {bid} has refcount 0"
        self._meta_dirty.clear()
