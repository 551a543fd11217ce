"""End-to-end paper experiment: workloads -> (baseline | MARS) -> DRAM
(port of ``repro/core/experiment.py``).

Reproduces the paper's Figures 7 (achieved-bandwidth uplift) and 8
(CAS/ACT uplift) over workloads WL1-WL5, and Figure 2 (locality vs
observation window vs core count).  ``device`` picks where the two device
scans run: ``"cuda"`` (the default; raises without a GPU) launches the
MARS engine and DRAM channel kernels, ``"cpu"`` runs their plain twins.
Both give the reference's integers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import dram, mars, streams


@dataclasses.dataclass(frozen=True)
class WorkloadResult:
    name: str
    baseline: dram.DramResult
    with_mars: dram.DramResult

    @property
    def bw_uplift(self) -> float:
        return self.with_mars.achieved_gbps / self.baseline.achieved_gbps - 1.0

    @property
    def cas_act_uplift(self) -> float:
        return self.with_mars.cas_per_act / self.baseline.cas_per_act - 1.0


def run_workload(name: str, *,
                 gpu: streams.GpuConfig | None = None,
                 mars_cfg: mars.MarsConfig | None = None,
                 dram_cfg: dram.DramConfig | None = None,
                 reqs_per_core: int = 512,
                 seed: int = 0, device="cuda") -> WorkloadResult:
    gpu = gpu or streams.GpuConfig()
    mars_cfg = mars_cfg or mars.MarsConfig()
    dram_cfg = dram_cfg or dram.DramConfig()
    wl = streams.make_workload(name, gpu, reqs_per_core=reqs_per_core, seed=seed)
    base = dram.simulate(wl.addr, dram_cfg, is_write=wl.is_write,
                         device=device)
    # each shader-core group feeds its own boundary port
    ports = np.asarray(wl.source) // gpu.cores_per_group
    perm, _ = mars.mars_reorder(wl.addr, ports, mars_cfg,
                                src=np.asarray(wl.source), device=device)
    perm = np.asarray(perm)
    with_ = dram.simulate(np.asarray(wl.addr)[perm], dram_cfg,
                          is_write=np.asarray(wl.is_write)[perm],
                          device=device)
    return WorkloadResult(name, base, with_)


def run_all(*, gpu: streams.GpuConfig | None = None,
            mars_cfg: mars.MarsConfig | None = None,
            dram_cfg: dram.DramConfig | None = None,
            reqs_per_core: int = 512, seed: int = 0,
            device="cuda") -> list[WorkloadResult]:
    """``run_workload`` for every workload, the five streams together:
    one MARS engine run over the five (one kernel launch on a CUDA
    device), then one DRAM run over the ten baseline and MARS-ordered
    streams (one launch)."""
    gpu = gpu or streams.GpuConfig()
    wls = {n: streams.make_workload(n, gpu, reqs_per_core=reqs_per_core,
                                    seed=seed) for n in streams.WORKLOADS}
    return mars_results(wls, [mars_cfg or mars.MarsConfig()], gpu=gpu,
                        dram_cfg=dram_cfg, device=device)[0]


def mars_results(workloads: dict, mars_cfgs, *, gpu: streams.GpuConfig,
                 dram_cfg: dram.DramConfig | None = None,
                 device="cuda") -> list[list[WorkloadResult]]:
    """``WorkloadResult``s of the workload streams ``workloads`` (name ->
    stream, made under ``gpu``) under each MARS configuration of
    ``mars_cfgs``: a list a configuration, in the order of
    ``workloads``.  Every (configuration, stream) pair's reorder runs in
    one MARS engine run, then the baseline streams, each served once,
    and every reordered stream in one DRAM run.  Each ``WorkloadResult``
    equals ``run_workload``'s."""
    dram_cfg = dram_cfg or dram.DramConfig()
    names, wls = list(workloads), list(workloads.values())
    src = [np.asarray(wl.source) for wl in wls]
    items = [(wl.addr, s // gpu.cores_per_group, cfg, s)
             for cfg in mars_cfgs for wl, s in zip(wls, src)]
    perms = [np.asarray(p) for p, _ in mars.mars_reorder_many(
        items, device=device)]
    n = len(wls)
    res = dram.simulate_many(
        [(wl.addr, wl.is_write) for wl in wls]
        + [(np.asarray(wls[i % n].addr)[p],
            np.asarray(wls[i % n].is_write)[p])
           for i, p in enumerate(perms)], dram_cfg, device=device)
    return [[WorkloadResult(name, res[i], res[n + c * n + i])
             for i, name in enumerate(names)] for c in range(len(mars_cfgs))]


def summarize(results: list[WorkloadResult]) -> dict:
    bw = np.array([r.bw_uplift for r in results])
    ca = np.array([r.cas_act_uplift for r in results])
    return {
        "mean_bw_uplift": float(bw.mean()),
        "mean_cas_act_uplift": float(ca.mean()),
        "per_wl_bw": {r.name: float(r.bw_uplift) for r in results},
        "per_wl_cas_act": {r.name: float(r.cas_act_uplift) for r in results},
    }


def locality_experiment(core_counts=(24, 40, 64),
                        windows=(128, 512, 2048, 8192, 16384),
                        reqs_per_core: int = 1024) -> dict:
    """Paper Figure 2: locality at a single cache vs at the GPU boundary,
    as core count grows (host numpy only: no device scan)."""
    out = {"single_cache": streams.locality_sweep(
        streams.single_cache_stream(reqs_per_core=16384), windows)}
    for n in core_counts:
        gpu = streams.GpuConfig(n_cores=n, cores_per_group=8)
        wl = streams.make_workload("WL1", gpu, reqs_per_core=reqs_per_core)
        out[f"gpu_boundary_{n}cores"] = streams.locality_sweep(wl.addr, windows)
    return out
