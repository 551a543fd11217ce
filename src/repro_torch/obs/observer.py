"""Per-shard load summary (port of ``shard_load_snapshot`` from
``repro/obs/observer.py``).

``shard_load_snapshot`` is the single per-shard load/occupancy summary
the routing layers consume (``ShardedBlockPool.route``/``least_loaded``
and ``ShardedPagedBackend.prefill``): the ``load`` and ``headroom``
columns are the pool's routing metric (live + reserved) and reservation
headroom (free + cached − reserved), so every consumer ranks shards by
the same numbers.  The ``Observer`` hub that wires the serving stack for
telemetry arrives with the observability slice.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry


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
