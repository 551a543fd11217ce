"""MARS design-point ablations (port of ``benchmarks/ablations.py``).

The paper fixes RequestQ=512, PhyPageList=128x2-way and reports one point.
These ablations sweep each structure while holding the rest at paper
values and measure the mean bandwidth uplift over WL1-WL5.

Emits ``name,us_per_call,derived`` rows; derived = mean BW uplift.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import experiment, mars

RPC = 128  # keep each point cheap; trends match rpc=256

# (row name, MarsConfig field, values): the reference's grid
GRID = (("request_q", "request_q", (64, 128, 256, 512, 1024)),
        ("page_entries", "page_entries", (32, 64, 128, 256)),
        ("ways", "ways", (1, 2, 4)),
        ("n_ports", "n_ports", (1, 2, 8)),
        ("mshr", "mshr_per_core", (4, 16, 64)))


def configs():
    """Every ablation point: (row name, value, MarsConfig)."""
    return [(name, v, mars.MarsConfig(**{field: v}))
            for name, field, values in GRID for v in values]


def _uplift(mars_cfg, device) -> float:
    res = experiment.run_all(mars_cfg=mars_cfg, reqs_per_core=RPC,
                             device=device)
    return float(np.mean([r.bw_uplift for r in res]))


def run(emit, device="cuda"):
    for name, v, cfg in configs():
        t0 = time.perf_counter()
        u = _uplift(cfg, device)
        us = (time.perf_counter() - t0) * 1e6
        emit(f"ablation/{name}/{v}", us, f"bw_uplift={100*u:.1f}%")
