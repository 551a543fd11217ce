"""KV-cache placement rows through the paper's DRAM model (port of the
rows of ``benchmarks/kvcache_bench.py`` that call ``dram.simulate``).

A pool is churned by arriving/finishing sequences until fragmented, then a
decode batch's full KV gather (``ops.kv_read_trace``: per-lane block reads
interleaved by the parallel gather) is served by ``core.dram.simulate``.
MARS placement packs each sequence's blocks into few DRAM row
neighborhoods, so the interleaved lanes land in distinct banks instead of
thrashing rows; the naive LIFO free list scatters blocks after churn.

  placement  MARS vs naive placement, and the same traces after a
             bounded-window ``reorder.mars_order`` pass
  decode     the gather path's round-robin lane interleave vs the
             reference kernel's sequence-major page walk
             (``ops.kv_read_trace_kernel``), bandwidth and row-hit rate
  sharded    per-shard traces of a mesh-sharded pool, each shard its own
             memory device
  tier       a batched promotion's write stream, MARS-reordered vs in
             arrival order

Every row is an integer of the model (seeded churn, deterministic
simulation), so the port must give the reference's values exactly
(``results/bench_baseline.json``).  ``device`` picks where ``simulate``'s
channel scan runs (``"cuda"``: the kernel; ``"cpu"``: its plain twin).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import dram
from repro_torch.core.reorder import mars_order
from repro_torch.core.streams import PAGE_SHIFT
from repro_torch.kernels.paged_attention import ops
from repro_torch.kvcache import BlockPool, PoolConfig, ShardedBlockPool
from repro_torch.kvcache.prefix import BlockTable, PrefixCache
from repro_torch.kvcache.tiers import TierManager


def churned_pool(placement: str, *, num_blocks: int = 512, n_live: int = 16,
                 churn_events: int = 400, seed: int = 0):
    """Alloc/free sequences until the free list is realistically scattered;
    return (pool, live decode batch tables)."""
    rng = np.random.default_rng(seed)
    pool = BlockPool(PoolConfig(num_blocks=num_blocks, placement=placement))
    live: list[BlockTable] = []

    def start_one():
        t = BlockTable()
        for _ in range(int(rng.integers(2, 9))):
            t.blocks.append(pool.alloc(1, hint_blocks=t.blocks)[0])
        t.num_tokens = len(t.blocks) * pool.cfg.block_size
        live.append(t)

    for _ in range(churn_events):
        if len(live) >= n_live or (live and rng.random() < 0.5):
            t = live.pop(int(rng.integers(len(live))))
            for b in t.blocks:
                pool.decref(b)
        else:
            start_one()
    while len(live) > n_live:
        t = live.pop(0)
        for b in t.blocks:
            pool.decref(b)
    while len(live) < n_live:       # top up to a full decode batch
        start_one()
    pool.check_invariants()
    return pool, live


def placement_comparison(*, n_live: int = 16, grant_beats: int = 2,
                         reorder_window=None, seed: int = 0,
                         device="cuda") -> dict:
    """{placement: DramResult} for the same churn trace under both policies."""
    out = {}
    for placement in ("naive", "mars"):
        pool, tables = churned_pool(placement, n_live=n_live,
                                    churn_events=600, seed=seed)
        trace = ops.kv_read_trace(tables, grant_beats=grant_beats)
        if reorder_window is not None:
            perm = np.asarray(mars_order(
                np.asarray(trace, np.int64) >> PAGE_SHIFT,
                window=reorder_window))
            trace = np.asarray(trace)[perm]
        out[placement] = dram.simulate(trace, device=device)
    return out


def mean_uplift(n_live: int, seeds=(0, 1, 2), **kw) -> tuple[float, dict]:
    """Seed-averaged bandwidth uplift of MARS over naive placement."""
    ups, last = [], {}
    for seed in seeds:
        last = placement_comparison(n_live=n_live, seed=seed, **kw)
        ups.append(last["mars"].achieved_gbps
                   / last["naive"].achieved_gbps - 1)
    return float(np.mean(ups)), last


def row_hit_rate(res) -> float:
    """Row-buffer hit rate of a ``DramResult``: CAS that did not activate."""
    return 1.0 - res.n_act / max(res.n_requests, 1)


def decode_path_comparison(*, placement: str = "mars", n_live: int = 16,
                           grant_beats: int = 4, window_tokens: int = 0,
                           seed: int = 0, paths=("gather", "kernel"),
                           pool_tables=None, device="cuda") -> dict:
    """{path: DramResult} for one decode step over the same churned pool.

    ``gather``  the dense-view path: every lane's pages gathered in
                parallel, so the memory system sees the round-robin
                interleave of the per-lane streams.  A sliding window
                does not shrink this stream — the dense view gathers the
                whole table and masks afterwards.
    ``kernel``  the reference's Pallas ``paged_attention`` grid order:
                lanes one after another, each lane's pages in page-table
                order, page-contiguously.  With ``window_tokens`` > 0 the
                kernel's window page gate also drops pages entirely
                outside the sliding window from the address stream.
    """
    if pool_tables is None:
        pool_tables = churned_pool(placement, n_live=n_live,
                                   churn_events=600, seed=seed)
    pool, tables = pool_tables
    out = {}
    if "gather" in paths:
        out["gather"] = dram.simulate(
            ops.kv_read_trace(tables, grant_beats=grant_beats),
            device=device)
    if "kernel" in paths:
        out["kernel"] = dram.simulate(ops.kv_read_trace_kernel(
            tables, window_tokens=window_tokens,
            block_size=pool.cfg.block_size), device=device)
    return out


@dataclasses.dataclass
class ShardedDramResult:
    """Aggregate of per-shard ``DramResult``s: every shard is its own
    memory device serving only its shard's lanes, in parallel.  Row-hit
    aggregates by summing CAS/ACT counts; bandwidth sums across devices."""
    n_requests: int
    n_act: int
    achieved_gbps: float
    per_shard: list


def _aggregate_shards(results) -> ShardedDramResult:
    results = [r for r in results if r.n_requests > 0]
    return ShardedDramResult(
        n_requests=sum(r.n_requests for r in results),
        n_act=sum(r.n_act for r in results),
        achieved_gbps=float(sum(r.achieved_gbps for r in results)),
        per_shard=results)


def sharded_churned_pool(n_shards: int, *, num_blocks: int = 512,
                         n_live: int = 16, churn_events: int = 400,
                         seed: int = 0):
    """Churn a mesh-sharded pool with the same arrival/finish schedule as
    ``churned_pool`` (same rng draws), routing each arriving sequence to
    the least-loaded shard; returns (spool, [(shard, table), ...])."""
    rng = np.random.default_rng(seed)
    spool = ShardedBlockPool(
        PoolConfig(num_blocks=num_blocks, placement="mars"),
        n_shards=n_shards)
    live: list[tuple[int, BlockTable]] = []

    def start_one():
        s = min(range(n_shards),
                key=lambda i: (spool.shards[i].num_live, i))
        t = BlockTable()
        for _ in range(int(rng.integers(2, 9))):
            t.blocks.append(
                spool.shards[s].alloc(1, hint_blocks=t.blocks)[0])
        t.num_tokens = len(t.blocks) * spool.cfg.block_size
        live.append((s, t))

    for _ in range(churn_events):
        if len(live) >= n_live or (live and rng.random() < 0.5):
            s, t = live.pop(int(rng.integers(len(live))))
            for b in t.blocks:
                spool.shards[s].decref(b)
        else:
            start_one()
    while len(live) > n_live:
        s, t = live.pop(0)
        for b in t.blocks:
            spool.shards[s].decref(b)
    while len(live) < n_live:
        start_one()
    spool.check_invariants()
    return spool, live


def sharded_placement_comparison(*, n_shards: int = 4, n_live: int = 16,
                                 grant_beats: int = 2, churn_events: int = 600,
                                 seed: int = 0, device="cuda") -> dict:
    """Shard-routed MARS vs single-pool MARS vs naive, same churn trace.

    The single pool serves the whole decode batch from one memory device,
    so all ``n_live`` lanes interleave into one address stream; the
    sharded pool routes sequences to ``n_shards`` devices, each seeing
    only its own lanes' interleave.  Expected ordering: shard-routed MARS
    row-hit >= single-pool MARS >= naive.
    """
    out = {}
    for placement in ("naive", "mars"):
        _, tables = churned_pool(placement, n_live=n_live,
                                 churn_events=churn_events, seed=seed)
        out[f"single/{placement}"] = dram.simulate(
            ops.kv_read_trace(tables, grant_beats=grant_beats),
            device=device)
    spool, live = sharded_churned_pool(n_shards, n_live=n_live,
                                       churn_events=churn_events, seed=seed)
    per_shard = []
    for s in range(n_shards):
        tables_s = [t for sh, t in live if sh == s]
        per_shard.append(dram.simulate(
            ops.kv_read_trace(tables_s, grant_beats=grant_beats),
            device=device))
    out["sharded/mars"] = _aggregate_shards(per_shard)
    return out


def tiered_promotion_comparison(*, n_prefixes: int = 24,
                                num_blocks: int = 64, block_size: int = 16,
                                seed: int = 0, device="cuda") -> dict:
    """{mode: DramResult} for the same batched promotion copy-in, written
    MARS-reordered vs in arrival order.

    Setup (identical under both modes, same rng): register ``n_prefixes``
    single-block prefixes, demote them all under pool pressure, fragment
    the free list with a shuffled alloc/free pass so promotion
    destinations scatter across row groups, then ``match`` all prompts in
    one lookahead batch and ``flush_promotions``.  The flush's destination
    order is replayed through ``core/dram.simulate`` as a write stream.
    """
    out = {}
    for mode, reorder in (("mars", True), ("naive", False)):
        rng = np.random.default_rng(seed)
        pool = BlockPool(PoolConfig(num_blocks=num_blocks,
                                    block_size=block_size,
                                    placement="naive"))
        cache = PrefixCache(block_size)
        cache.attach(pool)
        tiers = TierManager(pool, cache, reorder=reorder)
        prompts = []
        for i in range(n_prefixes):
            prompt = [int(t) for t in rng.integers(1, 10_000, block_size)]
            prompt.append(i + 1)           # tail token: prefix < prompt
            t = BlockTable()
            t.extend(pool, prompt, seq_tokens=prompt, cache=cache)
            cache.release(t, pool)
            prompts.append(prompt)
        grab = pool.alloc(pool.num_free + pool.num_cached)  # demote all
        assert tiers.stats.demotes == n_prefixes
        for b in grab:
            pool.decref(b)
        # fragment: re-grab everything, free a shuffled half
        grab = pool.alloc(num_blocks)
        freed = rng.permutation(num_blocks)[:num_blocks // 2]
        for i in freed:
            pool.decref(grab[i])
        for p in prompts:                  # one lookahead batch
            tiers.match(p)
        assert tiers.pending == n_prefixes
        dsts = tiers.flush_promotions()
        trace = TierManager.write_trace(dsts)
        out[mode] = dram.simulate(trace, is_write=np.ones(len(trace), bool),
                                  device=device)
    return out


def run(emit, smoke: bool = False, device="cuda") -> None:
    """The reference's ``kvcache_bench.run`` rows that call
    ``dram.simulate``, under the same names."""
    lanes = (8,) if smoke else (8, 32)
    seeds = (0,) if smoke else (0, 1, 2)
    for n_live in lanes:     # decode lanes: more lanes = deeper interleave
        t0 = time.perf_counter()
        uplift, res = mean_uplift(n_live, seeds=seeds, device=device)
        us = (time.perf_counter() - t0) * 1e6
        for placement, r in res.items():
            emit(f"kvcache/placement/{placement}/lanes{n_live}", us / 6,
                 f"{r.achieved_gbps:.2f}GB/s")
        emit(f"kvcache/placement/uplift/lanes{n_live}", us / 6,
             f"{100 * uplift:.2f}%")
    if not smoke:
        # with the MC-side MARS reorder buffer in front (window = RequestQ)
        t0 = time.perf_counter()
        res = placement_comparison(n_live=32, reorder_window=512,
                                   device=device)
        us = (time.perf_counter() - t0) * 1e6
        uplift = res["mars"].achieved_gbps / res["naive"].achieved_gbps - 1
        emit("kvcache/placement+reorder/uplift", us / 2,
             f"{100 * uplift:.2f}%")
    # decode-path bandwidth: gather-path interleave vs the kernel's
    # sequence-major page walk, same placed pool
    mars_pt = None
    for placement in ("naive", "mars"):
        t0 = time.perf_counter()
        pt = churned_pool(placement, n_live=16, churn_events=600, seed=0)
        res = decode_path_comparison(placement=placement, pool_tables=pt,
                                     device=device)
        us = (time.perf_counter() - t0) * 1e6
        if placement == "mars":
            mars_pt = pt
        for path, r in res.items():
            emit(f"kvcache/decode/{path}/{placement}", us / 2,
                 f"{r.achieved_gbps:.2f}GB/s")
            emit(f"kvcache/decode/{path}/{placement}/rowhit", us / 2,
                 f"{100 * row_hit_rate(r):.2f}%")
    # sliding-window decode: only the kernel walk re-traces
    t0 = time.perf_counter()
    res = decode_path_comparison(window_tokens=64, paths=("kernel",),
                                 pool_tables=mars_pt, device=device)
    us = (time.perf_counter() - t0) * 1e6
    r = res["kernel"]
    emit("kvcache/decode/kernel/mars/window64", us,
         f"{r.achieved_gbps:.2f}GB/s")
    emit("kvcache/decode/kernel/mars/window64/rowhit", us,
         f"{100 * row_hit_rate(r):.2f}%")
    # mesh-sharded placement: per-shard traces, each shard its own device
    for i, n_shards in enumerate((2,) if smoke else (2, 4)):
        t0 = time.perf_counter()
        res = sharded_placement_comparison(n_shards=n_shards, n_live=16,
                                           device=device)
        us = (time.perf_counter() - t0) * 1e6
        emit(f"kvcache/placement/sharded/rowhit/shards{n_shards}", us / 3,
             f"{100 * row_hit_rate(res['sharded/mars']):.2f}%")
        if i == 0:      # single-pool baselines are shard-count-independent
            emit("kvcache/placement/sharded/rowhit/single-mars", us / 3,
                 f"{100 * row_hit_rate(res['single/mars']):.2f}%")
            emit("kvcache/placement/sharded/rowhit/single-naive", us / 3,
                 f"{100 * row_hit_rate(res['single/naive']):.2f}%")
        emit(f"kvcache/placement/sharded/gbps/shards{n_shards}", us / 3,
             f"{res['sharded/mars'].achieved_gbps:.2f}GB/s")
    # tier boundary: MARS-reordered batched promotion vs arrival order
    t0 = time.perf_counter()
    res = tiered_promotion_comparison(device=device)
    us = (time.perf_counter() - t0) * 1e6
    for mode, r in res.items():
        emit(f"kvcache/tier/promote/{mode}/rowhit", us / 2,
             f"{100 * row_hit_rate(r):.2f}%")
