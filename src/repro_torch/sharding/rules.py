"""Logical-axis -> mesh-axis rules (port of ``repro/sharding/rules.py``).

Model code names every parameter's dimensions with logical axes
(``models.layers``; ``lm.param_specs``); these rules translate them into
specs for a concrete mesh.  The production mesh axes are ("pod",)
"data", "model":

  TP  : heads / kv_heads / mlp / vocab / ssm_in  -> "model"
  EP  : expert                                   -> "model"
  FSDP: embed (weight rows)                      -> "data"  (ZeRO-3 style)
  DP  : batch                                    -> ("pod", "data")

A spec is a plain tuple with one entry a dimension, as JAX's
``PartitionSpec`` holds it: ``None``, an axis name, or a tuple of names
(outermost first; a one-name tuple is the name).  Every mapping is
divisibility-checked with fallbacks: a head count that does not divide
the model axis moves the sharding to the head_dim ("head") instead;
dimensions with no valid mapping replicate.  A mesh is any record with
``axis_names`` and a ``shape`` dict (``launch.mesh.Mesh``).

``local_slices`` gives the part of a tensor one mesh position holds
under a spec, and ``sharding.dtensor`` turns a spec into
``torch.distributed.tensor`` placements.  This module needs no torch.
"""
from __future__ import annotations

from typing import Any

# when the primary mapping doesn't divide, move the mesh axis to the dim
# with this logical name instead (if present and divisible)
_FALLBACK_DIM = {
    "heads": "head",
    "kv_heads": "head",
    "vocab": "embed",
    "ssm_heads": None,
}


def logical_rules(mesh, fsdp: bool = True) -> dict:
    has_pod = "pod" in mesh.axis_names
    data_axes = ("pod", "data") if has_pod else ("data",)
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert": "model",
        "ssm_in": "model",
        "ssm_small": None,
        "ssm_heads": "model",
        "embed": data_axes if fsdp else None,
        "head": None,
        "conv": None,
        "seq": None,
        "layers": None,
        "batch": data_axes,
    }


def _axis_size(mesh, name) -> int:
    """Size of a mesh axis, or the product over a tuple of axes."""
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape[n]
        return out
    return mesh.shape[name]


def _entry(axes: tuple):
    """A spec entry as ``PartitionSpec`` holds it: None for no axis, the
    name for one."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_for(axes, shape, rules, mesh) -> tuple:
    """Divisibility-checked spec for one parameter."""
    n = len(axes)
    out = [None] * n
    used = set()

    def mark(m):
        used.update(entry_axes(m))

    # first pass: primary mappings that divide
    pending = []
    for i, a in enumerate(axes):
        m = rules.get(a)
        if m is None:
            continue
        ms = tuple(x for x in entry_axes(m) if x not in used)
        if not ms:
            continue
        m2 = _entry(ms)
        if shape[i] % _axis_size(mesh, m2) == 0:
            out[i] = m2
            mark(m2)
        else:
            pending.append((i, a, m2))
    # second pass: fallback dims for failed mappings
    for i, a, m in pending:
        fb = _FALLBACK_DIM.get(a)
        if fb is None:
            continue
        if isinstance(m, tuple) or m in used:
            continue
        for j, b in enumerate(axes):
            if b == fb and out[j] is None \
                    and shape[j] % _axis_size(mesh, m) == 0:
                out[j] = m
                mark(m)
                break
    return tuple(out)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (tensors or None; a spec in
    ``rest`` is a leaf there), as nested dicts; a named tuple stays one."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, getattr(tree, f),
                                 *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if hasattr(tree, "keys"):
        return {k: _map(fn, tree[k], *(r[k] for r in rest))
                for k in tree.keys()}
    return fn(tree, *rest)


def param_shardings(specs_tree, params, mesh, fsdp: bool = True):
    """Map the logical-spec tree over the parameters (tensors, meta ones
    too: only shapes are read) to specs on ``mesh``, a tree of the
    parameters' structure."""
    rules = logical_rules(mesh, fsdp)
    return _map(lambda p, axes: spec_for(axes, tuple(p.shape), rules, mesh),
                params, specs_tree)


def batch_sharding(mesh, batch: int | None = None) -> tuple:
    """The spec of a batch's leading dimension: over the data axes that
    divide ``batch`` (("pod", "data"), then "data", then "pod"), else
    replicated."""
    has_pod = "pod" in mesh.axis_names
    cand = [("pod", "data"), ("data",), ("pod",)] if has_pod else [("data",)]
    if batch is not None:
        for axes in cand:
            if batch % _axis_size(mesh, axes) == 0:
                return (_entry(axes),)
        return ()
    return (_entry(cand[0]),)


def _pad(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def sharded_bytes_per_device(tree, shardings, mesh) -> int:
    """Analytic per-device bytes of a tree of tensors (meta ones too)
    under the given specs (ceil per sharded dim, matching GSPMD
    padding).  A None leaf counts nothing; a None spec replicates."""
    total = 0

    def one(leaf, spec):
        nonlocal total
        if leaf is None:
            return
        n = 1
        for dim, ax in zip(leaf.shape, _pad(spec or (), leaf.dim())):
            k = _axis_size(mesh, ax) if ax is not None else 1
            n *= -(-dim // k)
        total += n * leaf.element_size()
    _map(one, tree, shardings)
    return total


def replicated(mesh) -> tuple:
    return ()


def pool_shard_count(mesh) -> int:
    """How many shards a mesh gives the KV block pool: the size of the
    model axis (one pool per model shard —
    ``kvcache.sharded_pool.ShardedBlockPool``); 1 without a mesh or when
    the mesh has no model axis."""
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


def cache_shardings(mesh, cfg, batch: int, backend: str = "dense") -> Any:
    """KV cache (L,B,S,K,dh): batch on data axes; kv heads on model when
    divisible, otherwise the *sequence* dim shards on model (flash-decoding
    style partial attention).  SSM states shard heads on model when
    divisible.  Returns the specs as an ``lm.Cache``.

    Only the dense ``lm.Cache`` layout is covered (``backend="dense"``).
    A paged backend's KV lives in a host-side ``BlockPool`` with layout
    ``(L, num_blocks, page, K, dh)`` — handing these specs to it would
    silently shard the *page* axis as if it were the sequence axis, so
    any other ``backend`` raises: paged caches shard across the mesh via
    ``kvcache.sharded_pool.ShardedBlockPool`` (per-shard pools driving
    per-shard kernel calls), not via cache specs.
    """
    if backend != "dense":
        raise NotImplementedError(
            f"cache_shardings covers the dense lm.Cache layout only; "
            f"backend {backend!r} caches do not shard via cache specs — "
            f"use kvcache.sharded_pool.ShardedBlockPool (mesh-partitioned "
            f"block pools) for paged serving")
    has_pod = "pod" in mesh.axis_names
    d = ("pod", "data") if has_pod else ("data",)
    nm = mesh.shape["model"]
    nd = _axis_size(mesh, d)
    bspec = _entry(d) if batch % nd == 0 else None
    kv_on_heads = cfg.n_kv_heads % nm == 0
    if kv_on_heads:
        kv = (None, bspec, None, "model", None)
    else:
        kv = (None, bspec, "model", None, None)
    from repro_torch.models import ssm as ssm_mod
    if cfg.has_ssm:
        _, H, _, _ = ssm_mod.ssm_dims(cfg)
        ssm = (None, bspec, "model" if H % nm == 0 else None, None, None)
        # conv state is tiny; its (x|bc) channel split is shard-misaligned,
        # so replicate the channel dim rather than permute on every decode
        conv = (None, bspec, None, None)
    else:
        ssm = conv = ()
    enc_kv = (None, bspec, None, "model" if cfg.n_kv_heads % nm == 0
              else None, None)
    from repro_torch.models.lm import Cache
    return Cache(
        k=kv if cfg.has_attention else None,
        v=kv if cfg.has_attention else None,
        ssm=ssm if cfg.has_ssm else None,
        conv=conv if cfg.has_ssm else None,
        xk=enc_kv if cfg.family == "encdec" else None,
        xv=enc_kv if cfg.family == "encdec" else None,
        length=(),
    )


def mesh_coords(mesh, rank: int) -> dict:
    """Axis name -> coordinate of position ``rank`` (row-major over the
    mesh's axes, as ``jax.make_mesh`` and ``DeviceMesh`` lay out ranks)."""
    out = {}
    for name in reversed(mesh.axis_names):
        rank, out[name] = divmod(rank, mesh.shape[name])
    return {n: out[n] for n in mesh.axis_names}


def shard_index(mesh, axes, coords: dict) -> tuple:
    """(index, count) of the block that ``coords`` holds along a
    dimension split over ``axes`` (outermost first)."""
    index, count = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return index, count


def local_slices(spec, shape, mesh, coords: dict) -> tuple:
    """The (start, stop) of each dimension of a ``shape`` tensor that the
    mesh position ``coords`` holds under ``spec``: ceil-sized blocks, as
    JAX's ``devices_indices_map`` and ``DTensor``'s ``Shard`` cut them."""
    out = []
    for dim, entry in zip(shape, _pad(spec, len(shape))):
        index, count = shard_index(mesh, entry_axes(entry), coords)
        block = -(-dim // count)
        out.append((min(dim, index * block), min(dim, (index + 1) * block)))
    return tuple(out)


def local_shape(spec, shape, mesh, coords: dict) -> tuple:
    return tuple(b - a for a, b in local_slices(spec, shape, mesh, coords))


def sharded_axes(spec) -> tuple:
    """Every mesh axis a spec shards a dimension over."""
    return tuple(a for e in spec for a in entry_axes(e))
