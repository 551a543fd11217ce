"""Mesh-axis sizes for the KV pool (port of ``pool_shard_count`` and
``_axis_size`` from ``repro/sharding/rules.py``).

Only the serve path's half is ported: how many shards a mesh gives the
block pool.  The parameter-partitioning half of the reference module
(``logical_rules``, ``spec_for``, ``param_shardings``,
``batch_sharding``, ``cache_shardings``, ``sharded_bytes_per_device``)
is read only by the reference's training and dry-run entry points — its
serve path never hands the model a mesh — so it waits for the training
and dry-run slices (ROADMAP.md §1).
"""
from __future__ import annotations


def _axis_size(mesh, name) -> int:
    """Size of a mesh axis, or the product over a tuple of axes."""
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape[n]
        return out
    return mesh.shape[name]


def pool_shard_count(mesh) -> int:
    """How many shards a mesh gives the KV block pool: the size of the
    model axis (one pool per model shard —
    ``kvcache.sharded_pool.ShardedBlockPool``); 1 without a mesh or when
    the mesh has no model axis."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])
