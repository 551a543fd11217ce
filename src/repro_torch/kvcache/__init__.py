"""Paged KV-cache subsystem (port of ``repro/kvcache``).

  pool       fixed-capacity slab allocator over a preallocated KV buffer
  placement  MARS-aware block placement (co-scheduled blocks share a DRAM
             row neighborhood)
  prefix     ref-counted prefix sharing + copy-on-write block tables
  evict      reclaim of cached (refcount-0) blocks: fifo, lru, or cost
  sharded_pool  mesh-sharded pools: one ``BlockPool`` per shard, the
             shard coordinate leading the placement key; admission
             routing by prefix-page affinity, tier hint and shard load
  tiers      spill tiers: eviction demotes registered prefix blocks to
             host / mock-remote tiers, misses promote them back through a
             MARS-reordered batched copy-in; cost-aware eviction scoring
  backend    ``KVBackend`` protocol with ``DenseBackend``,
             ``PagedBackend`` and ``ShardedPagedBackend`` (imports the
             model stack, so not re-exported here: ``from
             repro_torch.kvcache.backend import ...``)
"""
from repro_torch.kvcache.evict import EvictionPolicy
from repro_torch.kvcache.placement import PlacementPolicy, placement_key, \
    row_group_of
from repro_torch.kvcache.pool import BlockPool, PoolConfig
from repro_torch.kvcache.prefix import BlockTable, PrefixCache
from repro_torch.kvcache.sharded_pool import ShardedBlockPool
from repro_torch.kvcache.tiers import TierManager, TierSpec, default_tiers

__all__ = [
    "BlockPool", "PoolConfig", "BlockTable", "PrefixCache",
    "PlacementPolicy", "EvictionPolicy", "row_group_of", "placement_key",
    "ShardedBlockPool", "TierManager", "TierSpec", "default_tiers",
]
