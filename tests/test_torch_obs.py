"""Differential tests of the port's telemetry (``repro_torch.obs``,
``core/dram``'s address map, ``core/streams``, the DRAM-trace builders of
``kernels/paged_attention/ops``) against the JAX package's.

Every case of ``tests/test_obs.py`` runs the same operations through both
packages and holds the port to the reference: registry snapshots, trace
events (under one fake clock, timestamps included), open-row hit counts
and the allocator's dirty sets.  The port's ``OpenRowCounter`` is held to
the reference's FR-FCFS ``dram.simulate`` (the JAX function) within its
0.1 %; the address map, the trace builders and the synthetic request
streams are bitwise the reference's.  Each replay through the
reference's ``dram.simulate`` also runs through the port's own, which
must equal it field for field.

A whole serve run is traced by both engines (float32 smoke qwen, the same
converted weights and requests, one fake clock): the events, with ``ts``
and ``dur_us`` dropped, are equal, and so are the snapshots' counters,
histogram counts and gauges.  Last, the port's ``launch.serve --metrics``
output in each of the reference CI's four obs smokes passes the
reference's own ``tools/check_metrics.py`` (unchanged, a subprocess) and
the port's ``python -m repro_torch.analysis.races`` replay."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import dram as jdram  # noqa: E402
from repro.core import streams as jstreams  # noqa: E402
from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro.kvcache import backend as jbackend  # noqa: E402
from repro.kvcache import pool as jpool  # noqa: E402
from repro.kvcache import prefix as jprefix  # noqa: E402
from repro.kvcache import sharded_pool as jsharded  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import dram as tdram  # noqa: E402
from repro_torch.core import streams as tstreams  # noqa: E402
from repro_torch.kernels.paged_attention import ops as tops  # noqa: E402
from repro_torch.kvcache import backend as tbackend  # noqa: E402
from repro_torch.kvcache import pool as tpool  # noqa: E402
from repro_torch.kvcache import prefix as tprefix  # noqa: E402
from repro_torch.kvcache import sharded_pool as tsharded  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
J = SimpleNamespace(obs=jobs, pool=jpool, prefix=jprefix, sharded=jsharded,
                    ops=jops, engine=jengine, sched=jsched, backend=jbackend,
                    dram=jdram, name="jax")
T = SimpleNamespace(obs=tobs, pool=tpool, prefix=tprefix, sharded=tsharded,
                    ops=tops, engine=tengine, sched=tsched, backend=tbackend,
                    dram=tdram, name="torch")


def _both(fn):
    """``fn`` on the reference, then on the port; their results must be
    equal.  Returns the port's."""
    want, got = fn(J), fn(T)
    assert got == want
    return got


def _raises(exc, fn, *a, **kw) -> bool:
    try:
        fn(*a, **kw)
    except exc:
        return True
    return False


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_counter_is_monotonic():
    def run(m):
        c = m.obs.Counter()
        c.inc(); c.inc(2)
        v = c.value
        bad = _raises(ValueError, c.inc, -1)
        return v, bad, c.value
    assert _both(run) == (3, True, 3)


def test_registry_get_or_create_and_kind_mismatch():
    def run(m):
        reg = m.obs.MetricsRegistry()
        same = reg.counter("a.b") is reg.counter("a.b")
        return (same, _raises(TypeError, reg.gauge, "a.b"),
                _raises(TypeError, reg.histogram, "a.b"))
    assert _both(run) == (True, True, True)


def test_histogram_bucket_edges_and_quantiles():
    def run(m):
        h = m.obs.Histogram(edges=(1.0, 2.0, 4.0))
        for v in [0.5] * 50 + [3.0] * 50:
            h.observe(v)
        h2 = m.obs.Histogram(edges=(1.0, 2.0))
        h2.observe(2.0)
        return list(h.counts), h.quantile(0.50), h.quantile(0.99), \
            list(h2.counts)
    counts, p50, p99, counts2 = _both(run)
    assert counts == [50, 0, 50, 0]
    assert p50 == pytest.approx(1.0)
    assert p99 == pytest.approx(3.96)
    assert counts2 == [0, 1, 0]


def test_histogram_overflow_clamps_to_last_edge():
    def run(m):
        h = m.obs.Histogram(edges=(1.0, 2.0))
        h.observe(100.0)
        return h.counts[-1], h.quantile(0.99), h.to_snapshot()
    last, p99, snap = _both(run)
    assert last == 1 and p99 == 2.0
    assert snap["count"] == 1 and snap["sum"] == 100.0


def test_snapshot_is_deterministic_across_insertion_order():
    def run(m):
        a, b = m.obs.MetricsRegistry(), m.obs.MetricsRegistry()
        a.inc("x.one", 2); a.set("y.g", 0.25); a.observe("z.h", 1.5)
        b.observe("z.h", 1.5); b.inc("x.one", 2); b.set("y.g", 0.25)
        return (json.dumps(a.snapshot(), sort_keys=True),
                json.dumps(b.snapshot(), sort_keys=True))
    sa, sb = _both(run)
    assert sa == sb


def test_adopt_aliases_the_live_counters():
    def run(m):
        class S(m.obs.StatGroup):
            FIELDS = {"allocs": 0}
        reg = m.obs.MetricsRegistry()
        s = S()
        reg.adopt("pool", s)
        s.allocs += 3
        v = reg.snapshot()["counters"]["pool.allocs"]
        reg.adopt("pool", s)                      # idempotent
        return v, _raises(ValueError, reg.adopt, "pool", S())
    assert _both(run) == (3, True)


def test_statgroup_facade_keeps_dataclass_ergonomics():
    def run(m):
        s = m.pool.PoolStats(allocs=2)
        out = [s.allocs, s.frees]
        s.evictions += 5
        out += [s.as_dict(), s == m.pool.PoolStats(allocs=2, evictions=5),
                "evictions=5" in repr(s),
                set(s.fields()) == set(m.pool.PoolStats.FIELDS),
                _raises(TypeError, m.pool.PoolStats, bogus=1),
                _raises(AttributeError, setattr, s, "bogus", 1),
                _raises(AttributeError, getattr, s, "bogus")]
        return out
    out = _both(run)
    assert out[:2] == [2, 0] and out[2]["evictions"] == 5
    assert all(out[3:])


# ---------------------------------------------------------------------------
# trace spans
# ---------------------------------------------------------------------------

def _fake_clock(step_us: float = 10.0):
    t = [0.0]

    def clk():
        t[0] += step_us * 1e-6
        return t[0]
    return clk


def test_trace_spans_nest_and_time_deterministically():
    def run(m):
        t = m.obs.TraceLog(clock=_fake_clock())
        with t.span("outer") as sp:
            sp["k"] = 1
            t.event("point", rid=7)
            with t.span("inner"):
                pass
        return t.events()
    evs = _both(run)
    assert [e["ev"] for e in evs] == ["outer", "point", "inner"]
    outer, point, inner = evs
    assert outer["depth"] == 0 and inner["depth"] == 1
    assert outer["k"] == 1 and point["rid"] == 7
    assert outer["ts"] < point["ts"] < inner["ts"]
    assert outer["dur_us"] > inner["dur_us"] > 0


def test_trace_ring_drops_oldest_and_counts():
    def run(m):
        t = m.obs.TraceLog(capacity=4, clock=_fake_clock())
        for i in range(6):
            t.event("e", i=i)
        return t.total, t.dropped, [e["i"] for e in t.events()]
    assert _both(run) == (6, 2, [2, 3, 4, 5])


def test_trace_flush_appends_jsonl_and_clears(tmp_path):
    def run(m):
        t = m.obs.TraceLog(clock=_fake_clock())
        t.event("a"); t.event("b")
        path = str(tmp_path / f"trace_{m.name}.jsonl")
        n = [t.flush(path)]
        empty = t.events() == []
        t.event("c")
        n.append(t.flush(path))
        return n, empty, Path(path).read_text()
    n, empty, text = _both(run)
    assert n == [2, 1] and empty
    lines = [json.loads(line) for line in text.splitlines()]
    assert [e["ev"] for e in lines] == ["a", "b", "c"]
    assert all(isinstance(e["ts"], int) for e in lines)


# ---------------------------------------------------------------------------
# the open-row model against the reference's DRAM controller
# ---------------------------------------------------------------------------

def _churned_tables(m, placement="mars", num_blocks=256, n_live=12, seed=0):
    """The reference test's fragmented pool and live decode tables."""
    rng = np.random.default_rng(seed)
    pool = m.pool.BlockPool(m.pool.PoolConfig(num_blocks=num_blocks,
                                              placement=placement))
    live = []

    def start():
        t = m.prefix.BlockTable()
        for _ in range(int(rng.integers(2, 7))):
            t.blocks.append(pool.alloc(1, hint_blocks=t.blocks)[0])
        t.num_tokens = len(t.blocks) * pool.cfg.block_size
        live.append(t)

    for _ in range(200):
        if len(live) >= n_live or (live and rng.random() < 0.5):
            for b in live.pop(int(rng.integers(len(live)))).blocks:
                pool.decref(b)
        else:
            start()
    while len(live) < n_live:
        start()
    return pool, live


def _sim_hit_rate(trace) -> float:
    """The reference's FR-FCFS controller (the JAX function), beside the
    port's own ``dram.simulate`` replay of the same trace (its channel
    kernel's plain twin), which must give every field exactly."""
    res = jdram.simulate(trace)
    port = tdram.simulate(trace, device="cpu")
    assert dataclasses.asdict(port) == dataclasses.asdict(res)
    return 1.0 - res.n_act / max(res.n_requests, 1)


def _kernel_trace(seed=0):
    pool, tables = _churned_tables(T, seed=seed)
    trace = np.asarray(tops.kv_read_trace_kernel(
        tables, block_size=pool.cfg.block_size))
    jp, jt = _churned_tables(J, seed=seed)
    np.testing.assert_array_equal(trace, np.asarray(
        jops.kv_read_trace_kernel(jt, block_size=jp.cfg.block_size)))
    return trace


def test_inorder_model_matches_dram_on_kernel_walk():
    """The port's in-order model matches the reference's windowed
    controller replay within 0.1 % on the kernel walk, fed in odd
    chunks, with the reference model's own hits and accesses."""
    trace = _kernel_trace()

    def run(m):
        rc = m.obs.OpenRowCounter()
        for i in range(0, len(trace), 173):
            rc.observe(trace[i:i + 173])
        return rc.hits, rc.served, rc.row_hit_rate
    hits, served, rate = _both(run)
    assert served == len(trace)
    assert abs(rate - _sim_hit_rate(trace)) < 1e-3


def test_inorder_model_is_chunking_invariant():
    trace = _kernel_trace(seed=3)

    def run(m):
        one = m.obs.OpenRowCounter(); one.observe(trace)
        chunked = m.obs.OpenRowCounter()
        for i in range(0, len(trace), 7):
            chunked.observe(trace[i:i + 7])
        return (one.hits, one.served), (chunked.hits, chunked.served)
    one, chunked = _both(run)
    assert one == chunked


def test_windowed_model_matches_dram_on_interleaved_trace():
    pool, tables = _churned_tables(T, seed=1)
    trace = np.asarray(tops.kv_read_trace(tables, grant_beats=4))
    _, jt = _churned_tables(J, seed=1)
    np.testing.assert_array_equal(
        trace, np.asarray(jops.kv_read_trace(jt, grant_beats=4)))

    def run(m):
        inorder = m.obs.OpenRowCounter(); inorder.observe(trace)
        win = m.obs.OpenRowCounter(window=int(m.dram.DramConfig().window))
        for i in range(0, len(trace), 61):
            win.observe(trace[i:i + 61])
        win.drain()
        return win.served, win.row_hit_rate, inorder.row_hit_rate
    served, win_rate, inorder_rate = _both(run)
    assert served == len(trace)
    assert win_rate == pytest.approx(_sim_hit_rate(trace), abs=1e-9)
    assert win_rate > inorder_rate


def test_rowsim_rejects_bad_window_and_handles_empty():
    def run(m):
        bad = _raises(ValueError, m.obs.OpenRowCounter, window=0)
        rc = m.obs.OpenRowCounter()
        rc.observe(np.empty(0, np.int64))
        return bad, rc.row_hit_rate, rc.served
    assert _both(run) == (True, 0.0, 0)


# ---------------------------------------------------------------------------
# the address map, the trace builders and the request streams, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_channels,n_banks", [(2, 8), (4, 16), (1, 4)])
def test_address_map_is_the_reference_map(n_channels, n_banks):
    rng = np.random.default_rng(n_channels * 10 + n_banks)
    addr = np.concatenate([rng.integers(0, 1 << 28, 4096),
                           np.arange(4096), [0, (1 << 31) - 1]])
    jc = jdram.DramConfig(n_channels=n_channels, n_banks=n_banks)
    tc = tdram.DramConfig(n_channels=n_channels, n_banks=n_banks)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.peak_gbps == jc.peak_gbps
    jch, jloc = jdram.split_channels(addr, jc)
    tch, tloc = tdram.split_channels(addr, tc)
    np.testing.assert_array_equal(tch, np.asarray(jch))
    np.testing.assert_array_equal(tloc, np.asarray(jloc))
    for want, got in zip(jdram.decode_lines(jloc, jc),
                         tdram.decode_lines(tloc, tc)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_address_map_refuses_a_channel_count_off_a_power_of_two():
    for m in (jdram, tdram):
        with pytest.raises(ValueError, match="power of two"):
            m.split_channels(np.arange(8), m.DramConfig(n_channels=3))


@pytest.mark.parametrize("window", [0, 1, 5, 16, 40])
def test_trace_builders_are_bitwise_the_reference(window):
    for seed in (0, 2):
        pool, tables = _churned_tables(T, seed=seed)
        _, jt = _churned_tables(J, seed=seed)
        for i, t in enumerate(tables):       # ragged lengths in a block
            t.num_tokens -= i % pool.cfg.block_size
            jt[i].num_tokens = t.num_tokens
        got = tops.kv_read_trace_kernel(tables, window_tokens=window,
                                        block_size=pool.cfg.block_size)
        want = jops.kv_read_trace_kernel(jt, window_tokens=window,
                                         block_size=pool.cfg.block_size)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.dtype == np.asarray(want).dtype
        for beats in (1, 4):
            np.testing.assert_array_equal(
                tops.kv_read_trace(tables, grant_beats=beats),
                np.asarray(jops.kv_read_trace(jt, grant_beats=beats)))
    for m, prefix in ((tops, tprefix), (jops, jprefix)):
        assert m.kv_read_trace([]).size == 0
        assert m.kv_read_trace_kernel([prefix.BlockTable()]).size == 0


@pytest.mark.parametrize("name", list(jstreams.WORKLOADS))
def test_request_streams_are_bitwise_the_reference(name):
    cfg_j = jstreams.GpuConfig(n_cores=16, cores_per_group=4)
    cfg_t = tstreams.GpuConfig(n_cores=16, cores_per_group=4)
    want = jstreams.make_workload(name, cfg_j, reqs_per_core=64, seed=5)
    got = tstreams.make_workload(name, cfg_t, reqs_per_core=64, seed=5)
    for f in ("addr", "is_write", "source"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    np.testing.assert_array_equal(got.page, want.page)
    assert got.n == want.n
    assert tstreams.locality_sweep(got.addr, (16, 64, 256)) == \
        jstreams.locality_sweep(want.addr, (16, 64, 256))
    np.testing.assert_array_equal(
        tstreams.single_cache_stream(cfg_t, 256, seed=1),
        jstreams.single_cache_stream(cfg_j, 256, seed=1))
    streams = [np.arange(n, dtype=np.int32) + 100 * n for n in (5, 0, 9, 3)]
    for beats in (1, 2, 7):
        for w, g in zip(jstreams._round_robin_merge(streams, beats),
                        tstreams._round_robin_merge(streams, beats)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="unknown workload"):
        tstreams.make_workload("WL9")


# ---------------------------------------------------------------------------
# shard load snapshot
# ---------------------------------------------------------------------------

def test_shard_load_snapshot_single_pool():
    def run(m):
        pool = m.pool.BlockPool(m.pool.PoolConfig(num_blocks=16,
                                                  block_size=4))
        pool.alloc(3)
        pool.reserve(2)
        reg = m.obs.MetricsRegistry()
        rows = m.obs.shard_load_snapshot(pool, reg)
        return rows, reg.snapshot()
    (row,), snap = _both(run)
    assert row == {"shard": 0, "blocks": 16, "live": 3, "cached": 0,
                   "free": 13, "reserved": 2, "load": 5, "headroom": 11,
                   "occupancy": 3 / 16}
    assert snap["gauges"]["pool.shard0.load"] == 5
    assert snap["gauges"]["pool.shard0.occupancy"] == pytest.approx(3 / 16)


def test_shard_load_snapshot_headroom_is_can_reserve():
    def run(m):
        sp = m.sharded.ShardedBlockPool(
            m.pool.PoolConfig(num_blocks=32, block_size=4), n_shards=2)
        sp.shards[0].alloc(5)
        sp.shards[1].reserve(3)
        rows = m.obs.shard_load_snapshot(sp)
        fits = [(s.can_reserve(r["headroom"]),
                 s.can_reserve(r["headroom"] + 1),
                 r["load"] == s.num_live + s.reserved)
                for r, s in zip(rows, sp.shards)]
        return rows, fits
    rows, fits = _both(run)
    assert [r["shard"] for r in rows] == [0, 1]
    assert fits == [(True, False, True)] * 2


# ---------------------------------------------------------------------------
# incremental pool invariants (--paranoid)
# ---------------------------------------------------------------------------

def test_incremental_sweep_is_o_dirty_and_clears():
    def run(m):
        pool = m.pool.BlockPool(m.pool.PoolConfig(num_blocks=32,
                                                  block_size=4))
        bids = pool.alloc(4)
        seen = [set(bids) <= pool._meta_dirty]
        pool.check_invariants(incremental=True)
        seen.append(set(pool._meta_dirty))
        pool.decref(bids[0])
        seen.append(set(pool._meta_dirty) == {bids[0]})
        pool.check_invariants(incremental=True)
        pool.check_invariants()
        return seen
    assert _both(run) == [True, set(), True]


def test_incremental_sweep_catches_planted_corruption():
    def run(m):
        pool = m.pool.BlockPool(m.pool.PoolConfig(num_blocks=32,
                                                  block_size=4))
        bids = pool.alloc(2)
        pool.check_invariants(incremental=True)
        pool.refcount[bids[1]] = 0             # live block, refcount zeroed
        pool._meta_dirty.add(bids[1])
        caught = _raises(AssertionError, pool.check_invariants,
                         incremental=True)
        pool.refcount[bids[1]] = 1             # repair; the sweep passes
        pool._meta_dirty.add(bids[1])
        pool.check_invariants(incremental=True)
        return caught
    assert _both(run) is True


def test_incremental_sweep_catches_aggregate_drift():
    def run(m):
        pool = m.pool.BlockPool(m.pool.PoolConfig(num_blocks=16,
                                                  block_size=4))
        pool.alloc(2)
        pool.used[5] = True                    # used without leaving free
        return _raises(AssertionError, pool.check_invariants,
                       incremental=True)
    assert _both(run) is True


# ---------------------------------------------------------------------------
# Observer end to end (toy engine)
# ---------------------------------------------------------------------------

def _rec_observer(m):
    class RecObserver(m.obs.Observer):
        """Also records every kv walk it is fed, for a replay through the
        reference's ``dram.simulate``."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.walks = []

        def observe_kv_walk(self, shard, addrs):
            self.walks.append(np.asarray(addrs))
            super().observe_kv_walk(shard, addrs)
    return RecObserver


def _toy_served(m, rec=False, **obs_kw):
    pool = m.pool.BlockPool(m.pool.PoolConfig(num_blocks=96, block_size=16,
                                              n_kv_heads=2, head_dim=32))
    kw = {"device": "cpu"} if m is T else {}
    eng = m.engine.ServeEngine(pool, m.sched.MarsScheduler(pool=pool),
                               max_lanes=4, **kw)
    cls = _rec_observer(m) if rec else m.obs.Observer
    obs = cls(clock=_fake_clock(), **obs_kw).attach(eng)
    rng = np.random.default_rng(0)
    pref = tuple(int(t) for t in rng.integers(1, 100, 20))
    reqs = [m.sched.Request(rid=i,
                            prompt=pref + tuple(int(t) for t in
                                                rng.integers(1, 100, 3)),
                            arrival=i * 1e-3, prefix_len=16, max_new=5,
                            n_samples=3 if i == 2 else 1)
            for i in range(8)]
    out = eng.run(reqs)
    assert sorted(out) == list(range(8))
    return eng, obs, out


def _host_free(snap: dict) -> dict:
    """A snapshot without what the host clock measured (histogram sums
    and quantiles): counters, gauges and histogram counts stay."""
    return {"counters": snap["counters"], "gauges": snap["gauges"],
            "trace": snap["trace"],
            "histograms": {k: v["count"]
                           for k, v in snap["histograms"].items()}}


def test_observer_live_row_gauge_matches_dram_replay():
    """The modelled row-hit gauge agrees with the reference's
    ``dram.simulate`` replay of the concatenated per-step walks within
    0.1 %, and with the reference observer's gauge on the same run."""
    def run(m):
        eng, obs, _ = _toy_served(m, rec=True, paranoid=True,
                                  paranoid_every=2)
        return (obs.registry.gauge("dram.row_hit_pct").value,
                obs.registry.counter("dram.kv_lines").value,
                [w.tolist() for w in obs.walks])
    gauge, lines, walks = _both(run)
    replay = 100.0 * _sim_hit_rate(np.concatenate(walks))
    assert abs(gauge - replay) < 0.1
    assert lines == sum(len(w) for w in walks)


def test_observer_snapshot_aliases_component_stats():
    # the step histogram's sums and quantiles are host time: held on the
    # port alone; everything else equals the reference's
    want = _toy_served(J)[1].snapshot()
    eng, obs, _ = _toy_served(T)
    snap = obs.snapshot()
    assert _host_free(snap) == _host_free(want)
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    assert c["engine.decode_tokens"] == eng.stats.decode_tokens == 10 * 5
    assert c["engine.prefill_tokens"] == eng.stats.prefill_tokens
    assert c["pool.allocs"] == eng.pool.stats.allocs
    assert c["sched.scheduled"] == eng.scheduler.stats.scheduled == 8
    assert h["engine.step_ms"]["count"] == eng.stats.steps
    assert h["engine.step_ms"]["p50"] <= h["engine.step_ms"]["p99"]
    assert 0.0 < g["kvcache.prefix_hit_rate"] <= 1.0
    assert snap["trace"]["events"] == obs.trace.total
    assert snap["trace"]["dropped"] == 0


def _no_time(evs):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur_us")}
            for e in evs]


def test_observer_trace_reconstructs_request_lifecycle():
    jeng, jobs_, jout = _toy_served(J)
    eng, obs, out = _toy_served(T)
    assert out == jout
    # one fake clock read per stamp: the timelines are equal, stamps too
    assert obs.trace.events() == jobs_.trace.events()
    evs = [e for e in obs.trace.events() if e.get("rid") == 2]
    names = [e["ev"] for e in evs]
    order = [names.index(k) for k in ("sched.offer", "engine.admit",
                                      "engine.prefill", "engine.token",
                                      "engine.free")]
    assert order == sorted(order)
    assert names.count("engine.token") == 3 * 5      # 3 forks x 5 tokens
    assert names.count("engine.free") == 3
    prefill = next(e for e in evs if e["ev"] == "engine.prefill")
    assert prefill["lanes"] == 3 and prefill["dur_us"] >= 0


def test_observer_off_leaves_no_trace_hooks():
    def run(m):
        pool = m.pool.BlockPool(m.pool.PoolConfig(num_blocks=96,
                                                  block_size=16,
                                                  n_kv_heads=2, head_dim=32))
        kw = {"device": "cpu"} if m is T else {}
        eng = m.engine.ServeEngine(pool, m.sched.MarsScheduler(pool=pool),
                                   max_lanes=4, **kw)
        before = (eng.obs, pool.obs, eng.scheduler.obs)
        out = eng.run([m.sched.Request(rid=0, prompt=tuple(range(1, 20)),
                                       prefix_len=16, max_new=3)])
        return before, eng.obs, eng.stats.decode_tokens, out
    assert _both(run)[:3] == ((None, None, None), None, 3)


# ---------------------------------------------------------------------------
# a whole serve run: the same trace as the reference's
# ---------------------------------------------------------------------------

ARCH = "qwen1_5_0_5b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
_MODEL: list = []


def _model():
    """(jax cfg, port cfg, jax params, port params), float32 smoke qwen,
    built once."""
    if not _MODEL:
        jc = dataclasses.replace(jconfigs.get_smoke(ARCH), **F32)
        tc = dataclasses.replace(tconfigs.get_smoke(ARCH), **F32)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        _MODEL.append((jc, tc, jp, convert.params_from_numpy(
            jax.tree.map(np.asarray, jp), tc, "cpu")))
    return _MODEL[0]


# the reference CI's obs smokes' serve shapes, cut to a few requests
SERVES = {
    "plain": dict(requests=10, batch=4, new_tokens=3),
    "shards": dict(requests=10, batch=4, new_tokens=3, shards=2),
    "tiered": dict(requests=24, batch=4, new_tokens=3, shards=2,
                   tiered=True, pool_blocks=12, prefixes=12),
    "classes": dict(requests=16, batch=4, new_tokens=3, classes=3,
                    pool_blocks=10),
}


def _serve_traced(m, requests, batch, new_tokens, shards=1, tiered=False,
                  pool_blocks=64, prefixes=4, classes=0):
    """``launch.serve.main_paged``'s engine, built by hand for one
    package, traced under a fake clock; returns (observer, served)."""
    jc, tc, jp, tp = _model()
    cfg, params = (jc, jp) if m is J else (tc, tp)
    kw = dict(num_blocks=pool_blocks, block_size=16, tiered=tiered,
              decode_mode="gather" if m is J else "kernel")
    if shards > 1:
        devs = {} if m is J else dict(devices=["cpu"] * shards)
        backend = m.backend.ShardedPagedBackend(cfg, n_shards=shards,
                                                **devs, **kw)
    else:
        backend = m.backend.PagedBackend(
            cfg, **({} if m is J else dict(device="cpu")), **kw)
    cls = m.sched.default_classes(classes) if classes > 1 else None
    sched = m.sched.MarsScheduler(pool=backend.pool, classes=cls)
    if tiered and shards > 1:
        sched.tier_probe = backend.tier_shard_for
    eng = m.engine.ServeEngine(backend.pool, sched,
                               m.engine.PagedLM(params, cfg, backend),
                               max_lanes=batch)
    obs = m.obs.Observer(paranoid=True, paranoid_every=2,
                         clock=_fake_clock()).attach(eng)
    names = [c.name for c in cls] if cls else None
    reqs = []
    for r in tserve.synth_requests(requests, cfg.vocab, n_prefixes=prefixes):
        cname = names[r.rid % len(names)] if names else "default"
        mult = tserve._CLASS_NEW_TOKENS.get(cname, 1) if names else 1
        reqs.append(m.sched.Request(rid=r.rid, prompt=r.prompt,
                                    arrival=r.arrival,
                                    prefix_len=r.prefix_len,
                                    max_new=new_tokens * mult,
                                    traffic_class=cname))
    out = eng.run(reqs)
    backend.pool.check_invariants()
    return obs, out


@pytest.mark.parametrize("kind", sorted(SERVES))
def test_serve_trace_equals_the_reference(kind):
    """The port's engine emits the JAX engine's trace, event for event
    (``ts``/``dur_us`` dropped: the stamps count clock reads), and the
    same counters, histogram counts and gauges — the modelled
    ``dram.row_hit_pct`` and ``kvcache.prefix_hit_rate`` included."""
    jo, jout = _serve_traced(J, **SERVES[kind])
    to, tout = _serve_traced(T, **SERVES[kind])
    assert tout == jout
    assert _no_time(to.trace.events()) == _no_time(jo.trace.events())
    snap, want = to.snapshot(), jo.snapshot()
    assert _host_free(snap) == _host_free(want)
    g = snap["gauges"]
    assert g["dram.row_hit_pct"] == want["gauges"]["dram.row_hit_pct"]
    assert g["kvcache.prefix_hit_rate"] == \
        want["gauges"]["kvcache.prefix_hit_rate"]
    names = {e["ev"] for e in to.trace.events()}
    assert {"backend.dispatch", "backend.decode", "backend.commit",
            "backend.prefill", "backend.stage", "engine.token",
            "pool.alloc"} <= names
    if SERVES[kind].get("tiered"):
        assert {"tier.demote", "tier.promote", "tier.stall"} <= names
        assert 0.0 <= g["tier.promote_row_hit_pct"] <= 100.0
    if SERVES[kind].get("classes"):
        assert {"engine.pause", "backend.pause", "backend.resume",
                "engine.resume", "sched.batch"} <= names
    for h in ("engine.commit_ms", "engine.dispatch_ms", "engine.sync_ms"):
        assert snap["histograms"][h]["count"] > 0


# ---------------------------------------------------------------------------
# the reference's validator on the port's --metrics output
# ---------------------------------------------------------------------------

# the reference CI's four obs smokes (.github/workflows/ci.yml): serve
# flags and the validator's mode
CI_SMOKES = {
    "pipeline": (["--shards", "2", "--kernel-decode", "--requests", "12",
                  "--batch", "4", "--new-tokens", "5", "--metrics",
                  "--paranoid"], ["--require-pipeline"]),
    "instrumented": (["--shards", "2", "--kernel-decode", "--metrics",
                      "--paranoid", "--requests", "12", "--batch", "4",
                      "--new-tokens", "5"], []),
    "tiered": (["--shards", "2", "--kernel-decode", "--tiered-kv",
                "--pool-blocks", "16", "--prefixes", "20", "--requests",
                "48", "--batch", "4", "--new-tokens", "6", "--metrics",
                "--paranoid"], ["--require-tiers"]),
    "classes": (["--classes", "3", "--pool-blocks", "16", "--requests",
                 "24", "--batch", "4", "--new-tokens", "6", "--metrics",
                 "--paranoid"], ["--require-classes", "--require-pipeline"]),
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


@pytest.mark.parametrize("smoke", sorted(CI_SMOKES))
def test_reference_validator_passes_the_port_output(smoke, tmp_path):
    flags, mode = CI_SMOKES[smoke]
    out = tserve.main(["--paged", "--config", ARCH, "--smoke", "--device",
                       "cpu", *flags, "--metrics-path", str(tmp_path)])
    assert out["obs"] is not None and out["parity_mismatches"] == 0
    snap, trace = tmp_path / "metrics.json", tmp_path / "trace.jsonl"
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_metrics.py"),
         str(snap), str(trace), *mode], env=_env(), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[metrics] ok" in res.stdout
    if "--require-pipeline" in mode:
        races_json = tmp_path / "races.json"
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.races", str(trace),
             "--require-pipeline", "--json", str(races_json)], env=_env(),
            capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stdout + res.stderr
        report = json.loads(races_json.read_text())
        assert report["ok"] and report["stats"]["lag_tokens"] > 0
    snap = json.loads(snap.read_text())
    assert snap["counters"]["engine.decode_tokens"] == out["decode_tokens"]
    assert snap["trace"]["dropped"] == 0
