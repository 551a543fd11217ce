"""MARS dispatch, gather, scheduler and engine benchmarks on the port
(counterpart of ``benchmarks/kernel_benches.py``).

Four benches, the reference's shapes and row names: K4's
``mars_moe_ffn`` against the einsum (capacity one-hot) baseline, K2's
sorted gather against the plain one, the MARS scheduler against FIFO,
and S1, the MARS cycle engine, on WL1.  ``device="cuda"`` (the default)
times the kernels with CUDA events after a warm-up call; ``"cpu"`` runs
their plain twins under the host clock.  ``us_per_call`` is a wall time,
not a roofline: the ``derived`` column is the access-pattern statistic
the reorder exists to improve (destination-run length, the CAS/ACT
analogue), and the scheduler's unique prefix blocks a batch and the
engine's cycles.  Every derived statistic is computed from what the
host holds (the MoE routing is taken on the host and handed to the
device), so a run on the card and one on the CPU print the same ones.
On the card, K4's FFN output and K2's gathered rows are also held
against their plain twins on host copies of the same inputs, one call
each outside the timed loop (``held``): a bench raises on a kernel that
disagrees, and ``TWIN_ERR`` keeps each largest difference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device


def _run_len(a: np.ndarray) -> float:
    return float(np.diff(np.flatnonzero(np.concatenate(
        [[True], a[1:] != a[:-1], [True]]))).mean())


# the largest absolute difference of each kernel's output from its twin's
# in the last run on the card, by row
TWIN_ERR: dict = {}
# K4's FFN in bf16 against its twin: a bf16 spacing of h may flip between
# the two accumulation orders; 2**-6 of the output's largest magnitude
# holds that and catches a wrong tile, which moves a row by its own size
MOE_TWIN_TOL = 2.0 ** -6


def held(name: str, got: torch.Tensor, want: torch.Tensor,
         atol: float) -> float:
    """The largest absolute difference of ``got`` (a kernel's output)
    from ``want`` (its twin's, on the host), kept in ``TWIN_ERR[name]``;
    raises beyond ``atol`` or on a shape or dtype that differs."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} "
                             f"against its twin's "
                             f"{want.dtype}{tuple(want.shape)}")
    err = (got.cpu().double() - want.double()).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{name}: the kernel lies {err} from its twin "
                             f"on the same inputs (allowed {atol})")
    TWIN_ERR[name] = err
    return err


def _timeit(fn, *args, n=5, device="cpu"):
    """Microseconds a call of ``fn(*args)`` over ``n`` calls after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn(*args)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    return (time.perf_counter() - t0) / n * 1e6


def moe_bench_config():
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="bench", family="moe", n_layers=1, d_model=256,
                       n_heads=4, n_kv_heads=4, d_ff=512, vocab=128,
                       n_experts=32, top_k=2, d_expert=512)


def bench_moe_dispatch(emit, device="cuda", params=None, x=None):
    """K4's sorted grouped FFN (``mars_moe_ffn`` through
    ``grouped_matmul``, the model's compute dtype) against the einsum
    baseline, T 2048, d 256, 32 experts top-2.  ``params`` (the MoE
    layer's) and ``x`` default to draws from seeds 0 and 1."""
    from repro_torch.kernels.moe_dispatch import ops
    from repro_torch.models import moe as moe_mod
    dev = resolve_device(device)
    cfg = moe_bench_config()
    T = 2048
    if params is None:
        params = moe_mod.moe_init(torch.Generator().manual_seed(0), cfg)
    if x is None:
        x = torch.randn((T, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
    params = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        idx, gates, _ = moe_mod.router_topk(params, x, cfg)
    p_dev = {k: v.to(dev) for k, v in params.items()}
    x_dev, idx_dev, g_dev = x.to(dev), idx.to(dev), gates.to(dev)
    cd = cfg.cdtype

    def mars(x, i, g, p=p_dev):
        return ops.mars_moe_ffn(x.to(cd), i, g, p["w_in"].to(cd),
                                p["w_gate"].to(cd), p["w_out"].to(cd),
                                n_experts=32, act=cfg.act, use_kernel=True)

    def base(x):
        return moe_mod.moe_apply_einsum(p_dev, x, cfg)[0]
    with torch.no_grad():
        if dev.type != "cpu":
            want = mars(x, idx, gates, params)
            held("moe_dispatch/mars_sorted", mars(x_dev, idx_dev, g_dev),
                 want, MOE_TWIN_TOL * want.abs().max().item())
        us_mars = _timeit(mars, x_dev, idx_dev, g_dev, device=dev)
        us_base = _timeit(base, x_dev, device=dev)
    flat = idx.reshape(-1).numpy()
    emit("moe_dispatch/mars_sorted", us_mars,
         f"run_len={_run_len(np.sort(flat)):.1f}")
    emit("moe_dispatch/einsum_baseline", us_base,
         f"run_len={_run_len(flat):.2f}")
    emit("moe_dispatch/speedup", 0.0, f"{us_base/us_mars:.2f}x")


def bench_mars_gather(emit, device="cuda"):
    """K2's sorted gather against the plain one: a 32768 x 512 float32
    table, 16384 zipf(1.3) ids (the reference's)."""
    from repro_torch.kernels.mars_gather import ops
    dev = resolve_device(device)
    table = torch.randn((1 << 15, 512),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.default_rng(0)
    ids_np = (rng.zipf(1.3, 1 << 14) % (1 << 15)).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    with torch.no_grad():
        if dev.type != "cpu":
            held("mars_gather/sorted",
                 ops.embedding_gather(table, ids, mode="sorted"),
                 ops.embedding_gather(table.cpu(), ids.cpu(), mode="plain"),
                 0.0)
        us_plain = _timeit(lambda t, i: ops.embedding_gather(
            t, i, mode="plain"), table, ids, device=dev)
        us_sorted = _timeit(lambda t, i: ops.embedding_gather(
            t, i, mode="sorted"), table, ids, device=dev)
    pages = ids_np >> 2
    emit("mars_gather/plain", us_plain,
         f"page_run={_run_len(pages):.2f}")
    emit("mars_gather/sorted", us_sorted,
         f"page_run={_run_len(np.sort(pages)):.1f}")


def bench_scheduler(emit, device="cuda"):
    """The MARS scheduler against FIFO over 256 requests on 16 prefixes
    (host code: ``device`` is not read)."""
    from repro_torch.serving.scheduler import (MarsScheduler, Request,
                                               unique_prefix_blocks)
    rng = np.random.default_rng(0)
    prefixes = [tuple(rng.integers(1, 100, 16).tolist()) for _ in range(16)]
    reqs = [Request(rid=i, prompt=prefixes[i % 16]
                    + tuple(rng.integers(1, 100, 4).tolist()),
                    arrival=i * 1e-3, prefix_len=16) for i in range(256)]
    for mars in (False, True):
        sched = MarsScheduler(mars=mars)
        pend = list(reqs)
        blocks, batches = 0, 0
        t0 = time.perf_counter()
        while pend or len(sched):
            while pend and sched.offer(pend[0]):
                pend.pop(0)
            b = sched.schedule_batch(16, now=1.0)
            if not b:
                break
            blocks += unique_prefix_blocks(b)
            batches += 1
        us = (time.perf_counter() - t0) * 1e6
        emit(f"scheduler/{'mars' if mars else 'fifo'}", us,
             f"prefix_blocks_per_batch={blocks/max(batches,1):.2f}")


def bench_mars_engine(emit, device="cuda"):
    """S1 (``mars.mars_reorder``) on WL1 at 128 requests a core (8192
    requests), host clock around the call."""
    from repro_torch.core import mars, streams
    wl = streams.make_workload("WL1", reqs_per_core=128)
    ports = np.asarray(wl.source) // 8
    mars.mars_reorder(wl.addr, ports, src=np.asarray(wl.source),
                      device=device)                  # build and warm up
    t0 = time.perf_counter()
    perm, stats = mars.mars_reorder(wl.addr, ports,
                                    src=np.asarray(wl.source),
                                    device=device)
    us = (time.perf_counter() - t0) * 1e6
    emit("mars_engine/reorder_8192req", us,
         f"cycles={stats['total_cycles']}")


def run(emit, device="cuda"):
    bench_moe_dispatch(emit, device)
    bench_mars_gather(emit, device)
    bench_scheduler(emit, device)
    bench_mars_engine(emit, device)
