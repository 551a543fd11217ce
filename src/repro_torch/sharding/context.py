"""Ambient mesh registry (port of ``repro/sharding/context.py``).

Layers that need the active mesh look it up here (the MoE layer's
expert-parallel dispatch); single-device code never sets one.
``launch/serve.py`` sets the serving mesh around the construction of a
sharded KV backend, ``launch/train.py`` the training mesh around the
run.  A mesh is any record with ``axis_names``, a ``shape`` dict and
``devices`` (``launch.mesh.Mesh``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

_MESH = None


def current_mesh():
    return _MESH


def data_axes(mesh) -> tuple:
    """All mesh axes used for data parallelism (pod+data when multi-pod)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


@contextlib.contextmanager
def use_mesh(mesh: Optional[object]):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev
