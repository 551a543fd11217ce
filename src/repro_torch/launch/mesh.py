"""Mesh construction (port of ``repro/launch/mesh.py``).

Single pod : (16, 16)    axes ("data", "model")   = 256 devices
Multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 devices

A mesh here is a small record (``Mesh``) with the fields the sharding
rules, the shard discovery and the entry points read: ``axis_names``,
``shape`` (axis name -> size), ``devices`` (one ``torch.device`` per
mesh position, row-major; empty for a record of devices this host does
not have, such as the production meshes) and, when the mesh spans the
processes of a ``torch.distributed`` process group, ``dist``: the
``DeviceMesh`` over them (``device_mesh``), whose per-axis groups carry
the collectives.  The reference's ``request_cpu_devices`` and
``auto_axis_types`` set XLA flags and mesh axis types and have no torch
form.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: dict                   # axis name -> size
    devices: tuple                # torch.device per position, row-major
    dist: Any = None              # DeviceMesh over the processes, if any

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh as a record (no devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, dict(zip(axes, shape)), ())


def device_mesh(mesh: Mesh, device_type: str | None = None):
    """The ``torch.distributed`` ``DeviceMesh`` over ``mesh``: rank r at
    mesh position r (row-major), one dimension per axis, named as the
    axes.  The process group must be initialized with exactly the mesh's
    size; ``device_type`` defaults to the kind of ``mesh.devices``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != mesh.size:
        raise ValueError(f"a mesh of {mesh.size} positions "
                         f"{dict(mesh.shape)} needs a process group of as "
                         f"many ranks; this one has {world}")
    kind = device_type or (mesh.devices[0].type if mesh.devices else "cpu")
    ranks = torch.arange(world).reshape(tuple(mesh.shape.values()))
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(mesh.axis_names))


def on_processes(mesh: Mesh, device_type: str | None = None) -> Mesh:
    """``mesh`` with its ``DeviceMesh`` (``device_mesh``) attached."""
    return dataclasses.replace(mesh, dist=device_mesh(mesh, device_type))


def _devices(device) -> list:
    kind = resolve_device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def make_local_mesh() -> Mesh:
    """1-device mesh with the production axis names ("data", "model"),
    on the CPU (the CPU tests' mesh)."""
    return Mesh(("data", "model"), {"data": 1, "model": 1},
                (torch.device("cpu"),))


def make_serve_mesh(n_shards: int, device="cuda") -> Mesh:
    """(1, n) serving mesh, axes ("data", "model"), over ``device``'s
    kind: the model axis is what ``ShardedBlockPool`` partitions the KV
    pool over.  When fewer devices exist than shards were asked for, the
    mesh shrinks to what is available and pool shards map onto its
    devices round-robin (one H100: every shard on ``cuda:0``)."""
    devs = _devices(device)
    n = max(1, min(n_shards, len(devs)))
    return Mesh(("data", "model"), {"data": 1, "model": n},
                tuple(devs[:n]))
