"""Paper-figure benchmarks: one function per paper artifact (port of
``benchmarks/paper_figures.py``).

Fig 2  -> bench_locality      (locality vs window vs core count)
Fig 7  -> bench_bandwidth     (achieved-BW uplift per workload)
Fig 8  -> bench_cas_act       (CAS/ACT uplift per workload)

Each emits ``name,us_per_call,derived`` CSV rows (derived = the figure's
headline quantity); the us column is the host's wall clock around the
whole experiment, simulator kernels included.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import experiment

RPC = 256


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e6


def bench_locality(emit) -> None:
    loc, us = _timed(lambda: experiment.locality_experiment(reqs_per_core=512))
    for series, vals in loc.items():
        for w, v in vals.items():
            emit(f"fig2/locality/{series}/w{w}", us / max(len(loc), 1),
                 f"{v:.3f}")


def workload_results(device="cuda"):
    return experiment.run_all(reqs_per_core=RPC, device=device)


def bench_bandwidth(emit, results, us: float = 0.0) -> None:
    for r in results:
        emit(f"fig7/bw_uplift/{r.name}", us / 5, f"{100 * r.bw_uplift:.2f}%")
    mean = np.mean([r.bw_uplift for r in results])
    emit("fig7/bw_uplift/mean", us / 5, f"{100 * mean:.2f}%")


def bench_cas_act(emit, results, us: float = 0.0) -> None:
    for r in results:
        emit(f"fig8/cas_act_uplift/{r.name}", us / 5,
             f"{100 * r.cas_act_uplift:.2f}%")
    mean = np.mean([r.cas_act_uplift for r in results])
    emit("fig8/cas_act_uplift/mean", us / 5, f"{100 * mean:.2f}%")


def run(emit, device="cuda") -> None:
    bench_locality(emit)
    results, us = _timed(lambda: workload_results(device))
    bench_bandwidth(emit, results, us)
    bench_cas_act(emit, results, us)
    emit("paper/workload_sim_total", us, f"{len(results)}wl")
