"""Specs as ``torch.distributed.tensor`` placements, and the collectives
a sharded training step runs over a mesh's axes.

A mesh that spans processes (``launch.mesh.Mesh`` with ``dist``, its
``DeviceMesh``) holds each sharded tensor as a ``DTensor``: ``Shard(d)``
on every mesh dimension that the spec (``sharding.rules``) names for
tensor dimension d, ``Replicate()`` on the others.  A tuple entry
``("pod", "data")`` is pod-major, as in JAX: ``DTensor`` cuts a
dimension over the mesh dimensions in mesh order, outermost first.  So a
rank holds exactly ``rules.local_slices`` of each leaf, and its bytes
are the reference's ``sharded_bytes_per_device``.

The model's layers read plain tensors: the step fetches each leaf's
arithmetic cut (``fetch``, ``rules.model_cut``) and returns each cut's
gradient to its leaf's placement (``return_grad``) itself, summing over
the axes the batch is split on and over the model ranks that computed
parts of a leaf.  ``full_tensor()``'s own backward would take a
``Replicate`` dimension's gradient as already summed, and keep only this
rank's slice of a ``Shard`` one.  Every reduction runs in float32.
Under tensor parallelism the layers reach ``model``'s collectives
through ``ModelRank`` (``model_rank()`` of the ambient mesh).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.sharding import rules


def placements(spec, mesh) -> list:
    """The placements of a ``spec`` tensor on ``mesh``: one per mesh
    axis, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        axes = rules.entry_axes(entry)
        pos = [mesh.axis_names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {mesh.axis_names}")
        for i in pos:
            out[i] = Shard(d)
    return out


def spec_of(t, mesh) -> tuple:
    """The spec of a ``DTensor`` (the inverse of ``placements``); ()
    for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return ()
    axes = [[] for _ in range(t.dim())]
    for name, p in zip(mesh.axis_names, t.placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return tuple(rules._entry(tuple(a)) for a in axes)


def mesh_of(t):
    """The ``launch.mesh.Mesh`` record of a ``DTensor``'s ``DeviceMesh``."""
    from repro_torch.launch.mesh import Mesh
    dm = t.device_mesh
    return Mesh(tuple(dm.mesh_dim_names), dict(zip(dm.mesh_dim_names,
                                                   dm.shape)), (), dm)


def zeros(shape, spec, mesh, dtype, device):
    """A ``DTensor`` of zeros of global ``shape`` placed by ``spec``."""
    part = rules.local_shape(spec, shape, mesh, coords(mesh))
    return distribute(torch.zeros(part, dtype=dtype, device=device), spec,
                      mesh)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """A ``DTensor``'s local part (a view sharing its storage), or ``t``."""
    return t.to_local() if is_dtensor(t) else t


def coords(mesh) -> dict:
    """This process's position on ``mesh`` (axis name -> coordinate)."""
    return rules.mesh_coords(mesh, dist.get_rank())


def local_part(full, spec, mesh, skip=()) -> torch.Tensor:
    """This rank's part of ``full`` under ``spec`` (a contiguous copy),
    cutting no dimension over the axes in ``skip``."""
    spec = tuple(rules._entry(tuple(a for a in rules.entry_axes(e)
                                    if a not in skip)) for e in spec)
    region = rules.local_slices(spec, full.shape, mesh, coords(mesh))
    return full[tuple(slice(a, b) for a, b in region)].contiguous()


def distribute(part, spec, mesh):
    """A ``DTensor`` over ``mesh.dist`` whose local part is ``part``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(part, mesh.dist, placements(spec, mesh),
                              run_check=False)


def all_sum(x, mesh, axes):
    """Sum of ``x`` over the mesh axes ``axes`` (no gradient; a float one
    summed in float32, or float64), returned in x's dtype."""
    if not axes:
        return x
    wide = x.dtype if x.dtype == torch.float64 or not x.is_floating_point() \
        else torch.float32
    y = x.to(wide, copy=True)
    for a in axes:
        if mesh.shape[a] > 1:
            dist.all_reduce(y, group=mesh.dist.get_group(a))
    return y.to(x.dtype)


class _SumForward(torch.autograd.Function):
    """Forward: the sum over the axes; backward: the identity (each
    rank's part of the sum gets the whole incoming gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_sum(x, mesh, axes).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBackward(torch.autograd.Function):
    """Forward: the identity; backward: the sum of the gradients over the
    axes (a value every rank reads, each contributing part of its
    gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.mesh, ctx.axes), None, None


def sum_forward(x, mesh, axes):
    """The sum over ``axes`` of parts of a value every rank then reads
    alike (as the MoE columns' outputs over ``model``)."""
    return _SumForward.apply(x, mesh, tuple(axes))


def sum_backward(x, mesh, axes):
    """``x``, alike on every rank of ``axes``, whose gradient is summed
    from the ranks' parts (as the MoE columns' input over ``model``)."""
    return _SumBackward.apply(x, mesh, tuple(axes))


def reduce_grad(g, spec, mesh, batch_axes, keep=()):
    """The gradient of a leaf whole but over the axes in ``keep`` back at
    the leaf's placement ``spec``: summed over the axes the batch is
    split on, then this rank's part (a ``DTensor``)."""
    g = all_sum(g, mesh, batch_axes)
    return distribute(local_part(g, spec, mesh, skip=keep), spec, mesh)


class _AllSum(torch.autograd.Function):
    """The sum over the axes both ways: a value summed from every rank's
    part, whose gradient each rank's part receives summed from every
    rank (the ranks' objectives add up, as over the data axes)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_sum(x, mesh, axes).view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.mesh, ctx.axes), None, None


def all_sum_grad(x, mesh, axes):
    """The sum over ``axes`` of parts whose ranks' objectives add up (as
    the MoE router's statistics over the data axes, or a grouped norm's
    sum of squares over ``model``)."""
    return _AllSum.apply(x, mesh, tuple(axes))


def all_max(x, mesh, axes):
    """The largest of ``x`` over the mesh axes ``axes``; no gradient."""
    y = x.detach().clone()
    for a in axes:
        if mesh.shape[a] > 1:
            dist.all_reduce(y, op=dist.ReduceOp.MAX,
                            group=mesh.dist.get_group(a))
    return y


# ---------------------------------------------------------------------------
# Tensor parallelism over ``model``
# ---------------------------------------------------------------------------

class ModelRank:
    """This process's place on the ``model`` axis of a mesh over
    processes (``n`` ranks, this one ``r``), and the cuts the layers
    compute on (``rules.model_cut``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.shape["model"]
        self.r = coords(mesh)["model"]

    def heads(self, cfg) -> tuple:
        return rules.head_range(cfg, self.n, self.r)

    def kv(self, cfg) -> tuple:
        return rules.kv_range(cfg, self.n, self.r)

    def ssm_heads(self, cfg) -> tuple:
        return rules.ssm_head_range(cfg, self.n, self.r)

    def block(self, size: int) -> tuple:
        return rules.block_range(size, self.n, self.r)

    def sum_forward(self, x):
        return sum_forward(x, self.mesh, ("model",))

    def sum_backward(self, x):
        return sum_backward(x, self.mesh, ("model",))

    def sum_both(self, x):
        return all_sum_grad(x, self.mesh, ("model",))

    def sum(self, x):
        return all_sum(x, self.mesh, ("model",))

    def max(self, x):
        return all_max(x, self.mesh, ("model",))

    def put_together(self, part, dim: int, rng: tuple, size: int):
        """The whole of a value cut over ``model`` along ``dim`` (this
        rank's part ``part`` is ``[rng[0], rng[1])`` of ``size``), from
        every rank's part (zero-padded and summed: the parts must not
        overlap); no gradient."""
        shape = list(part.shape)
        shape[dim] = size
        full = part.new_zeros(shape)
        full.narrow(dim, rng[0], rng[1] - rng[0]).copy_(part)
        return all_sum(full, self.mesh, ("model",))

    def kv_heads_together(self, part, cfg, dim: int):
        """Every KV head of ``part``, which holds this rank's KV heads
        (``kv``) along ``dim``, put together over ``model``: each from
        the first rank that computes it (``rules.kv_owner``)."""
        k0, k1 = self.kv(cfg)
        own = [k for k in range(k0, k1)
               if rules.kv_owner(cfg, self.n, k) == self.r]
        lo, hi = (own[0], own[-1] + 1) if own else (k0, k0)
        return self.put_together(part.narrow(dim, lo - k0, hi - lo), dim,
                                 (lo, hi), cfg.n_kv_heads)


def model_rank(mesh=None):
    """The ``ModelRank`` of the ambient mesh (``sharding.context``) when
    it spans processes with a ``model`` axis above 1 (the layers then
    compute on their cuts), else None."""
    if mesh is None:
        from repro_torch.sharding import context as shctx
        mesh = shctx.current_mesh()
    if mesh is None or getattr(mesh, "dist", None) is None \
            or mesh.shape.get("model", 1) == 1:
        return None
    return ModelRank(mesh)


def _model_dim(spec):
    """The dimension a spec cuts over ``model``, or None."""
    for d, entry in enumerate(spec):
        if "model" in rules.entry_axes(entry):
            return d
    return None


def _cut_dim(cut):
    return next((d for d, c in enumerate(cut) if c is not None), None)


def _cut_index(ranges, device):
    return torch.cat([torch.arange(a, b, device=device) for a, b in ranges])


def take_cut(x, cut):
    """The cut of a whole (over ``model``) leaf ``x``: a copy."""
    d = _cut_dim(cut)
    if d is None:
        return x
    if len(cut[d]) == 1:
        a, b = cut[d][0]
        return x.narrow(d, a, b - a).contiguous()
    return x.index_select(d, _cut_index(cut[d], x.device))


def _store_range(spec, shape, mesh, j):
    """(dim, (start, stop)): the part of a leaf (``spec``, ``shape``)
    that model rank ``j`` stores over ``model``; None where the leaf is
    replicated over ``model``."""
    d = _model_dim(spec)
    if d is None:
        return None
    if rules.entry_axes(spec[d]) != ("model",):
        raise ValueError(f"spec entry {spec[d]!r} cuts one dimension over "
                         f"model and other axes: no cut fetch for it")
    only = tuple("model" if i == d else None for i in range(len(spec)))
    at = dict(coords(mesh), model=j)
    return d, rules.local_slices(only, shape, mesh, at)[d]


def _pieces(cut, store) -> list:
    """The pieces of the cut ``cut`` that a rank storing ``store``
    (``_store_range``) holds, in the order they travel: for each, the
    region it fills in the storage's local part and the region in the
    cut (dim -> (start, stop); a dimension not named is whole)."""
    d = _cut_dim(cut)
    if d is None:
        return [({}, {} if store is None else {store[0]: store[1]})]
    out, at = [], 0
    for a, b in cut[d]:
        if store is None:
            out.append(({d: (a, b)}, {d: (at, at + b - a)}))
        elif store[0] == d:
            s0, s1 = store[1]
            lo, hi = max(a, s0), min(b, s1)
            if lo < hi:
                out.append(({d: (lo - s0, hi - s0)},
                            {d: (at + lo - a, at + hi - a)}))
        else:
            out.append(({d: (a, b)},
                        {d: (at, at + b - a), store[0]: store[1]}))
        at += b - a
    return out


def _region(x, where: dict):
    for d, (a, b) in where.items():
        x = x.narrow(d, a, b - a)
    return x


def _crosses(cuts, store) -> bool:
    """Whether a rank's cut holds a piece that another rank stores (the
    same answer on every rank); where none does, nothing travels."""
    n = len(cuts)
    return any(all(b > a for a, b in dst.values())
               for j in range(n) for q in range(n) if j != q
               for _, dst in _pieces(cuts[j], store[q]))


def _exchange(send: list, shapes: list, like, mesh, cross: bool) -> list:
    """One all-to-all over ``mesh``'s ``model`` group: ``send[j]`` the
    tensors for model rank j, ``shapes[j]`` the shapes of those to
    receive from it (in ``like``'s dtype and device); returns the
    received tensors, rank by rank.  Without ``cross`` (``_crosses``)
    only this rank's own pieces are not empty, and no collective runs."""
    if not cross:
        r = coords(mesh)["model"]
        return [send[r] if j == r else [like.new_empty(s) for s in ss]
                for j, ss in enumerate(shapes)]
    group = mesh.dist.get_group("model")
    flat = [t.reshape(-1) for ts in send for t in ts]
    buf = torch.cat(flat) if flat else like.new_empty(0)
    counts = [sum(math.prod(s) for s in ss) for ss in shapes]
    out = like.new_empty(sum(counts))
    dist.all_to_all_single(out, buf, counts,
                           [sum(t.numel() for t in ts) for ts in send],
                           group=group)
    got, at = [], 0
    for ss in shapes:
        got.append([])
        for s in ss:
            got[-1].append(out[at:at + math.prod(s)].view(s))
            at += math.prod(s)
    return got


def _cut_local_shape(x, cut, store, shape) -> list:
    """The shape of a rank's cut of a leaf of ``shape`` whose stored part
    (over ``model``, ``store``) is ``x``: whole over ``model``."""
    out = list(x.shape)
    if store is not None:
        out[store[0]] = shape[store[0]]
    d = _cut_dim(cut)
    if d is not None:
        out[d] = sum(b - a for a, b in cut[d])
    return out


def _check_cut_dim(spec, cut):
    d = _cut_dim(cut)
    if d is not None and any(a != "model" for a in rules.entry_axes(
            spec[d] if d < len(spec) else None)):
        raise ValueError(f"spec {spec} splits the cut dimension {d} over "
                         f"a data axis: no cut fetch for it")


def fetch(t, mesh, cuts):
    """A leaf as a rank of ``mesh`` computes with it: its arithmetic cut
    (``cuts[r]`` on model rank r; ``cuts`` holds every model rank's,
    ``rules.model_cut``), gathered whole over every other mesh axis,
    detached.  Over ``model`` only the cut travels: a leaf replicated
    there is sliced here; otherwise each rank sends each other rank the
    pieces of that rank's cut that its stored part holds (one
    all-to-all: a head-dim or embed-dim fallback, ``w_zx``'s two halves,
    KV heads shared by ranks; none where every cut lies in its own
    rank's stored part).  Then the data axes are gathered by
    ``DTensor``'s all-gather."""
    n = mesh.shape.get("model", 1)
    r = coords(mesh)["model"] if n > 1 else 0
    if not is_dtensor(t):
        return take_cut(t.detach(), cuts[r])
    from torch.distributed.tensor import DTensor, Replicate, Shard
    spec = spec_of(t, mesh)
    _check_cut_dim(spec, cuts[r])
    x = t.detach().to_local()
    store = [_store_range(spec, t.shape, mesh, j) for j in range(n)]
    if n == 1 or store[r] is None:
        x = take_cut(x, cuts[r])
    else:
        out = x.new_empty(_cut_local_shape(x, cuts[r], store[r], t.shape))
        send = [[_region(x, src) for src, _ in _pieces(cuts[j], store[r])]
                for j in range(n)]
        mine = [_pieces(cuts[r], store[j]) for j in range(n)]
        got = _exchange(send, [[tuple(_region(out, dst).shape)
                                for _, dst in ps] for ps in mine], x, mesh,
                        _crosses(cuts, store))
        for ps, ts in zip(mine, got):
            for (_, dst), piece in zip(ps, ts):
                _region(out, dst).copy_(piece)
        x = out
    here = [Replicate() if name == "model" else p
            for name, p in zip(mesh.axis_names, t.placements)]
    if any(isinstance(p, Shard) and mesh.shape[name] > 1
           for name, p in zip(mesh.axis_names, here)):
        x = DTensor.from_local(x, mesh.dist, here, run_check=False) \
            .redistribute(mesh.dist, [Replicate()] * len(here)).to_local()
    return x


def return_grad(g, p, mesh, cuts, batch_axes):
    """The gradient ``g`` of a leaf's cut (``fetch(p, mesh, cuts)``)
    back at the leaf's placement (a ``DTensor``): summed over the axes
    the batch is split on and cut to this rank's part over them; then,
    over ``model``, the transpose of ``fetch``'s all-to-all: each rank
    sends each other rank the pieces of its cut's gradient that rank
    stores, and sums what it receives (ranks whose cuts overlap, as KV
    heads shared by ranks, or every rank's cut of a leaf replicated over
    ``model``).  Only cuts travel.  A whole leaf's gradient is whole on
    every model rank and is not summed over ``model``."""
    spec = spec_of(p, mesh)
    n = mesh.shape.get("model", 1)
    r = coords(mesh)["model"] if n > 1 else 0
    _check_cut_dim(spec, cuts[r])
    g = local_part(all_sum(g, mesh, batch_axes), spec, mesh, skip=("model",))
    store = [_store_range(spec, p.shape, mesh, j) for j in range(n)]
    if _cut_dim(cuts[r]) is None:
        part = g if store[r] is None else _region(
            g, {store[r][0]: store[r][1]}).contiguous()
        return distribute(part, spec, mesh)
    wide = torch.float64 if g.dtype == torch.float64 else torch.float32
    acc = torch.zeros(p.to_local().shape, dtype=wide, device=g.device)
    send = [[_region(g, dst) for _, dst in _pieces(cuts[r], store[j])]
            for j in range(n)]
    theirs = [_pieces(cuts[q], store[r]) for q in range(n)]
    got = _exchange(send, [[tuple(_region(acc, src).shape) for src, _ in ps]
                           for ps in theirs], g, mesh,
                    _crosses(cuts, store))
    for ps, ts in zip(theirs, got):
        for (src, _), piece in zip(ps, ts):
            _region(acc, src).add_(piece)
    return distribute(acc.to(g.dtype), spec, mesh)
