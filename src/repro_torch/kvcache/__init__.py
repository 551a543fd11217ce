"""Paged KV-cache subsystem (port of ``repro/kvcache``).

  pool       fixed-capacity slab allocator over a preallocated KV buffer
  placement  MARS-aware block placement (co-scheduled blocks share a DRAM
             row neighborhood)
  prefix     ref-counted prefix sharing + copy-on-write block tables
  evict      reclaim of cached (refcount-0) blocks
  backend    ``KVBackend`` protocol with ``DenseBackend`` and
             ``PagedBackend`` (imports the model stack, so not re-exported
             here: ``from repro_torch.kvcache.backend import ...``)

Mesh-sharded pools and spill tiers are not ported yet (ROADMAP.md).
"""
from repro_torch.kvcache.evict import EvictionPolicy
from repro_torch.kvcache.placement import PlacementPolicy, placement_key, \
    row_group_of
from repro_torch.kvcache.pool import BlockPool, PoolConfig
from repro_torch.kvcache.prefix import BlockTable, PrefixCache

__all__ = [
    "BlockPool", "PoolConfig", "BlockTable", "PrefixCache",
    "PlacementPolicy", "EvictionPolicy", "row_group_of", "placement_key",
]
