"""MARS design-point ablations (port of ``benchmarks/ablations.py``).

The paper fixes RequestQ=512, PhyPageList=128x2-way and reports one point.
These ablations sweep each structure while holding the rest at paper
values and measure the mean bandwidth uplift over WL1-WL5.

Emits ``name,us_per_call,derived`` rows; derived = mean BW uplift.  The
whole grid runs as one batch (``sweep``: one MARS engine launch and one
DRAM launch on a CUDA device), so each row's ``us_per_call`` is the
sweep's wall time over its points, as ``paper_figures`` divides its wall
time over its workloads.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import experiment, mars, streams

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


def sweep(device="cuda", rpc: int = RPC) -> list:
    """Mean bandwidth uplift over WL1-WL5 of every grid point, in
    ``configs()`` order: the workloads made once, every point's reorders
    in one MARS engine run and every served stream in one DRAM run
    (``experiment.mars_results``; on a CUDA device one launch each).
    Each value equals the mean of ``experiment.run_all(mars_cfg=...)``'s
    uplifts at that point."""
    gpu = streams.GpuConfig()
    wls = {n: streams.make_workload(n, gpu, reqs_per_core=rpc)
           for n in streams.WORKLOADS}
    per_cfg = experiment.mars_results(
        wls, [cfg for _, _, cfg in configs()], gpu=gpu, device=device)
    return [float(np.mean([r.bw_uplift for r in res])) for res in per_cfg]


def run(emit, device="cuda"):
    """One row a grid point; ``us_per_call`` is the sweep's wall time
    over its points (the grid runs as one batch)."""
    t0 = time.perf_counter()
    uplifts = sweep(device, RPC)
    us = (time.perf_counter() - t0) * 1e6 / len(uplifts)
    for (name, v, _), u in zip(configs(), uplifts):
        emit(f"ablation/{name}/{v}", us, f"bw_uplift={100*u:.1f}%")
