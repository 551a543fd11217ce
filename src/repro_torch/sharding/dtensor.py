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

The model's layers read plain tensors: the step gathers each leaf
(``gather``) and returns each gradient to its leaf's placement
(``reduce_grad``) itself, summing over the axes the batch is split on.
``full_tensor()``'s own backward would take a ``Replicate`` dimension's
gradient as already summed, and keep only this rank's slice of a
``Shard`` one.  Every reduction runs in float32.
"""
from __future__ import annotations

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


def gather(t, mesh, keep=()):
    """A leaf as the layers read it: a ``DTensor`` gathered whole over
    every mesh axis but those in ``keep`` (an all-gather), detached; a
    plain tensor as it is."""
    if not is_dtensor(t):
        return t.detach()
    from torch.distributed.tensor import Replicate
    to = [p if name in keep else Replicate()
          for name, p in zip(mesh.axis_names, t.placements)]
    return t.detach().redistribute(mesh.dist, to).to_local()


def reduce_grad(g, spec, mesh, batch_axes, keep=()):
    """The gradient of a gathered leaf (``gather(t, mesh, keep)``) back
    at the leaf's placement ``spec``: summed over the axes the batch is
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
    the MoE router's statistics over the data axes)."""
    return _AllSum.apply(x, mesh, tuple(axes))
