"""Serving mesh construction (port of ``make_serve_mesh`` and
``make_local_mesh`` from ``repro/launch/mesh.py``).

A mesh here is a small record (``Mesh``) with the fields the shard
discovery and the serve entry point read: ``axis_names``, ``shape`` (axis
name -> size) and ``devices`` (one ``torch.device`` per mesh position).
The devices are the CUDA devices ``torch.cuda.device_count()`` reports,
or the one CPU device.  The reference's ``request_cpu_devices`` and
``auto_axis_types`` set XLA flags and mesh axis types and have no torch
form; the production-mesh constructor belongs to the training and
dry-run slices.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: dict                   # axis name -> size
    devices: tuple                # torch.device per position, row-major


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
