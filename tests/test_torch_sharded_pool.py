"""Differential tests of the port's mesh-sharded pools
(``kvcache.sharded_pool``) and ``ShardedPagedBackend`` against the JAX
package's: the 21 cases of ``tests/test_sharded_pool.py``.  Routes,
defers, reservations and the soak's allocator state must equal the
reference's step by step; backends hold their allocator state and shard
placement equal and their logits within float32 tolerance (the JAX
backend decodes in ``"gather"`` mode, the port's in ``"kernel"`` mode,
its plain twin on CPU tensors), and engines serve the JAX engine's tokens
with the same ``shard_defers``.  The soak runs under each package's
``analysis.refsan`` and an ``Observer(paranoid=True)``, as in the
reference; the two packages' traces and snapshots must be equal."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.analysis import refsan as jrefsan  # noqa: E402
from repro.kvcache import placement as jplacement  # noqa: E402
from repro.kvcache import pool as jpool  # noqa: E402
from repro.kvcache import prefix as jprefix  # noqa: E402
from repro.kvcache import sharded_pool as jsharded  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.analysis import refsan as trefsan  # noqa: E402
from repro_torch.kvcache import placement as tplacement  # noqa: E402
from repro_torch.kvcache import pool as tpool  # noqa: E402
from repro_torch.kvcache import prefix as tprefix  # noqa: E402
from repro_torch.kvcache import sharded_pool as tsharded  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

torch.set_num_threads(1)

J = SimpleNamespace(pool=jpool, prefix=jprefix, sharded=jsharded,
                    sched=jsched, placement=jplacement, obs=jobs,
                    refsan=jrefsan)
T = SimpleNamespace(pool=tpool, prefix=tprefix, sharded=tsharded,
                    sched=tsched, placement=tplacement, obs=tobs,
                    refsan=trefsan)
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def _spool(m, num_blocks=32, n_shards=2, block_size=4, **kw):
    return m.sharded.ShardedBlockPool(
        m.pool.PoolConfig(num_blocks=num_blocks, block_size=block_size,
                          **kw), n_shards=n_shards)


def _same_shards(jsp, tsp):
    """Routing and allocator state of two sharded pools, bitwise."""
    assert tsp.n_shards == jsp.n_shards
    assert tsp.shard_blocks == jsp.shard_blocks
    assert tsp._pending == jsp._pending
    assert tsp._rid_shard == jsp._rid_shard
    assert tsp._rid_reserved == jsp._rid_reserved
    assert list(tsp._page_shard.items()) == list(jsp._page_shard.items())
    assert tsp.reserved == jsp.reserved
    assert tsp.stats.as_dict() == jsp.stats.as_dict()
    for jp, tp in zip(jsp.shards, tsp.shards):
        np.testing.assert_array_equal(tp.used, jp.used)
        np.testing.assert_array_equal(tp.refcount, jp.refcount)
        np.testing.assert_array_equal(tp.arrival, jp.arrival)
        assert tp.content == jp.content
        assert list(tp._evictable) == list(jp._evictable)
        assert tp.placement.free_ids() == jp.placement.free_ids()
        assert tp.reserved == jp.reserved
        assert tp.stats.as_dict() == jp.stats.as_dict()


def _both(fn):
    """``fn(m)`` -> (sharded pool, result) on both packages; equal state
    and results."""
    (jsp, jr), (tsp, tr) = fn(J), fn(T)
    _same_shards(jsp, tsp)
    assert tr == jr
    tsp.check_invariants()
    return tsp, tr


# ---------------------------------------------------------------------------
# partitioning + mesh discovery
# ---------------------------------------------------------------------------

def test_shards_partition_the_pool():
    def fn(m):
        sp = _spool(m, num_blocks=32, n_shards=4)
        assert sp.n_shards == 4 and sp.shard_blocks == 8
        assert all(s.cfg.num_blocks == 8 for s in sp.shards)
        assert sp.num_free == 32 and sp.num_live == 0
        with pytest.raises(AssertionError):
            _spool(m, num_blocks=30, n_shards=4)   # must divide evenly
        return sp, (sp.num_free, sp.num_cached, sp.num_live)
    _both(fn)


def test_mesh_discovery_from_model_axis():
    from repro.launch import mesh as jmesh
    from repro.sharding import rules as jrules
    from repro.sharding.context import use_mesh as juse
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import rules as trules
    from repro_torch.sharding.context import use_mesh as tuse

    got = []
    for m, mesh_mod, rules, use in ((J, jmesh, jrules, juse),
                                    (T, tmesh, trules, tuse)):
        mesh = mesh_mod.make_local_mesh()            # model axis size 1
        out = [rules.pool_shard_count(None), rules.pool_shard_count(mesh),
               m.sharded.ShardedBlockPool(m.pool.PoolConfig(num_blocks=16),
                                          mesh=mesh).n_shards]
        with use(mesh):                              # ambient discovery
            out.append(m.sharded.ShardedBlockPool(
                m.pool.PoolConfig(num_blocks=16)).n_shards)
        out.append(m.sharded.ShardedBlockPool(
            m.pool.PoolConfig(num_blocks=16)).n_shards)
        got.append(out)
    assert got[1] == got[0] == [1, 1, 1, 1, 1]


def test_placement_key_leads_with_shard():
    for mod in (tplacement, jplacement):
        assert mod.placement_key(63, 8, shard=0) < \
            mod.placement_key(0, 8, shard=1)
        assert mod.placement_key(5, 8) == (0, mod.row_group_of(5, 8), 5)
    for bid, shard in ((0, 0), (63, 1), (17, 3)):
        assert tplacement.placement_key(bid, 8, shard=shard) == \
            jplacement.placement_key(bid, 8, shard=shard)


# ---------------------------------------------------------------------------
# two-phase admission routing
# ---------------------------------------------------------------------------

def test_route_prefix_affinity_cohabits_pages():
    def fn(m):
        sp = _spool(m, num_blocks=32, n_shards=2)
        sp.reserve(2)
        s0 = sp.route(rid=0, page="hot", n=2)
        sp.reserve(2)
        s1 = sp.route(rid=1, page="hot", n=2)
        sp.reserve(2)
        s2 = sp.route(rid=2, page="cold", n=2)
        assert s1 == s0 and s2 != s0
        assert sp.reserved == 6 and sp._pending == 0
        return sp, (s0, s1, s2)
    _both(fn)


def test_route_defers_when_no_shard_has_headroom():
    def fn(m):
        sp = _spool(m, num_blocks=8, n_shards=2)   # 4 blocks per shard
        out = []
        sp.reserve(4)
        out.append(sp.route(rid=0, page="a", n=4))
        sp.reserve(4)
        out.append(sp.route(rid=1, page="b", n=4))
        assert not sp.can_reserve(1)
        sp.reserve(2)
        out.append(sp.route(rid=2, page="c", n=2))
        assert out[-1] is None and sp._pending == 2    # queued, not lost
        sp.unreserve(4, rid=0)
        out.append(sp.route(rid=2, page="c", n=2))
        assert out[-1] is not None
        return sp, out
    _both(fn)


def test_can_reserve_requires_single_shard_fit():
    def fn(m):
        sp = _spool(m, num_blocks=16, n_shards=2)  # 8 per shard
        out = [sp.can_reserve(n) for n in (1, 8, 9, 10, 16)]
        assert out == [True, True, False, False, False]
        return sp, out
    _both(fn)


def test_scheduler_routes_admissions_by_page_and_load():
    def fn(m):
        sp = _spool(m, num_blocks=64, n_shards=2, block_size=8)
        sched = m.sched.MarsScheduler(pool=sp)
        pa, pb = tuple(range(1, 9)), tuple(range(101, 109))
        reqs = [m.sched.Request(rid=i, prompt=(pa if i % 2 == 0 else pb)
                                + (200 + i,), prefix_len=8, max_new=4)
                for i in range(6)]
        for r in reqs:
            assert sched.offer(r)
        batch = sched.schedule_batch(6, now=1.0)
        shard_of = {r.rid: r._shard for r in batch}
        sa = {shard_of[r.rid] for r in reqs if r.prompt[:8] == pa}
        sb = {shard_of[r.rid] for r in reqs if r.prompt[:8] == pb}
        assert len(sa) == 1 and len(sb) == 1 and sa != sb
        return sp, ([r.rid for r in batch], shard_of,
                    sched.stats.as_dict())
    _both(fn)


def test_scheduler_defers_until_a_shard_frees():
    def fn(m):
        sp = _spool(m, num_blocks=16, n_shards=2, block_size=8)
        sched = m.sched.MarsScheduler(pool=sp)
        reqs = [m.sched.Request(rid=i,
                                prompt=tuple(range(1 + 32 * i, 33 + 32 * i)),
                                prefix_len=8, max_new=8) for i in range(3)]
        for r in reqs:
            assert sched.offer(r)
        batch = sched.schedule_batch(8, now=1.0)
        assert [r.rid for r in batch] == [0, 1]
        assert sched.stats.shard_defers == 1 and len(sched) == 1
        sp.unreserve(5, rid=batch[0].rid)
        batch2 = sched.schedule_batch(8, now=2.0)
        assert [r.rid for r in batch2] == [2]
        return sp, ([r._shard for r in batch + batch2],
                    sched.stats.as_dict())
    _both(fn)


# ---------------------------------------------------------------------------
# backends: cross-shard parity vs a single pool / dense backend
# ---------------------------------------------------------------------------

_MODEL: dict = {}


def _model(f32: bool = True):
    """(jax cfg, port cfg, jax params, port params): the qwen1.5-0.5b
    smoke config, the reference's init converted to the port."""
    if f32 not in _MODEL:
        from repro import configs as jconfigs
        from repro.models import lm as jlm
        from repro_torch import configs as tconfigs
        from repro_torch import convert
        kw = F32 if f32 else {}
        jc = dataclasses.replace(jconfigs.get_smoke("qwen1_5_0_5b"), **kw)
        tc = dataclasses.replace(tconfigs.get_smoke("qwen1_5_0_5b"), **kw)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _MODEL[f32] = (jc, tc, jp, tp)
    return _MODEL[f32]


def _sharded(n_shards=2, f32=True, **kw):
    """The JAX and the port's ``ShardedPagedBackend`` alike."""
    from repro.kvcache.backend import ShardedPagedBackend as JSharded
    from repro_torch.kvcache.backend import ShardedPagedBackend as TSharded
    jc, tc, jp, tp = _model(f32)
    return (JSharded(jc, n_shards=n_shards, decode_mode="gather", **kw),
            TSharded(tc, n_shards=n_shards, decode_mode="kernel",
                     devices=["cpu"] * n_shards, **kw), jp, tp)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("decode_mode", ["gather", "kernel"])
def test_sharded_paged_parity_vs_dense(decode_mode):
    """Rows routed across two shard pools decode to the port's dense
    backend's logits and to the JAX sharded backend's, with the same
    placement of rows on shards."""
    from repro.kvcache.backend import ShardedPagedBackend as JSharded
    from repro.models import lm as jlm
    from repro_torch.kvcache.backend import DenseBackend, \
        ShardedPagedBackend
    from repro_torch.models import lm as tlm
    jc, tc, jp, tp = _model()
    toks = _tokens(1, (4, 9), tc.vocab)
    dense = DenseBackend(tc, batch=4, max_seq=24, device="cpu")
    sharded = ShardedPagedBackend(tc, n_shards=2, num_blocks=64,
                                  block_size=4, decode_mode=decode_mode,
                                  devices=["cpu", "cpu"])
    jsharded_b = JSharded(jc, n_shards=2, num_blocks=64, block_size=4,
                          decode_mode="gather")
    assert sharded.decode_mode == decode_mode
    lg_d, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=dense)
    lg_p, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=sharded)
    lg_j, _ = jlm.prefill(jp, jc, jnp.asarray(toks), backend=jsharded_b)
    np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **TOL)
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **TOL)
    assert all(p.num_live > 0 for p in sharded.pool.shards)
    _same_shards(jsharded_b.pool, sharded.pool)
    tok = lg_d[:, -1].argmax(-1).to(torch.int32)[:, None]
    for _ in range(4):
        lg_d, _ = tlm.decode_step(tp, tc, tok, dense)
        lg_p, _ = tlm.decode_step(tp, tc, tok, sharded)
        lg_j, _ = jlm.decode_step(jp, jc, jnp.asarray(tok.numpy()),
                                  jsharded_b)
        np.testing.assert_allclose(lg_p.numpy(), lg_d.numpy(), **TOL)
        np.testing.assert_allclose(lg_p.numpy(), np.asarray(lg_j), **TOL)
        a = lg_d[:, -1].argmax(-1)
        assert torch.equal(a, lg_p[:, -1].argmax(-1))
        tok = a.to(torch.int32)[:, None]
    assert (sharded.lengths == dense.lengths).all()
    _same_shards(jsharded_b.pool, sharded.pool)
    sharded.release()
    sharded.pool.check_invariants()
    assert sharded.pool.num_live == 0
    with pytest.raises(RuntimeError, match="released"):
        sharded.decode_step(tp, torch.ones((4, 1), dtype=torch.int32))


def test_sharded_matches_single_pool_backend():
    """The same tokens through a 2-shard backend and a plain single-pool
    PagedBackend give the same logits; rows spread one a shard, as in the
    JAX backend."""
    from repro_torch.kvcache.backend import PagedBackend
    from repro_torch.models import lm as tlm
    jb, tb, jp, tp = _sharded(num_blocks=64, block_size=4)
    _, tc, _, _ = _model()
    single = PagedBackend(tc, num_blocks=32, block_size=4,
                          decode_mode="kernel", device="cpu")
    toks = _tokens(2, (2, 9), tc.vocab)
    lg_s, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=single)
    lg_h, _ = tlm.prefill(tp, tc, torch.from_numpy(toks), backend=tb)
    jb.prefill(jp, jnp.asarray(toks))
    np.testing.assert_allclose(lg_h.numpy(), lg_s.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert [p.num_live for p in tb.pool.shards] == [3, 3]
    _same_shards(jb.pool, tb.pool)
    for b in (single, tb, jb):
        b.release()


def test_fork_stays_shard_local_and_cow_isolates():
    jb, tb, jp, tp = _sharded(num_blocks=64, block_size=4)
    for b, p in ((jb, jp), (tb, tp)):
        sid, _, _ = b.new_seq(p, list(range(1, 11)), shard=1)
        fid = b.fork_seq(sid)
        assert b.shard_of(sid) == b.shard_of(fid) == 1
        pool1 = b.pool.shards[1]
        assert b.table(fid).blocks == b.table(sid).blocks
        assert all(pool1.used[x] for x in b.table(fid).blocks)
        assert b.pool.shards[0].num_live == 0
        cow0 = pool1.stats.cow_copies
        b.decode(p, [sid, fid], [3, 7])
        assert pool1.stats.cow_copies > cow0
        t_s, t_f = b.table(sid), b.table(fid)
        assert t_s.blocks[-1] != t_f.blocks[-1]
        assert pool1.content[t_s.blocks[-1]] != pool1.content[t_f.blocks[-1]]
    _same_shards(jb.pool, tb.pool)
    assert [(tb.table(s).blocks, tb.table(s).num_tokens) for s in (0, 1)] \
        == [(jb.table(s).blocks, jb.table(s).num_tokens) for s in (0, 1)]
    for b in (jb, tb):
        b.release()
        b.pool.check_invariants()


# ---------------------------------------------------------------------------
# soak: admit / fork / free with reservation routing
# ---------------------------------------------------------------------------

def _fake_clock():
    t = [0.0]

    def clk():
        t[0] += 1e-5
        return t[0]
    return clk


def _soak(m, trace_path, steps=300):
    """The reference soak's randomized admit (route + reserve + extend),
    fork (CoW) and free over a 4-shard metadata pool, the incremental
    sweep every step and the full one every 25, fully instrumented as in
    the reference: the package's ``refsan`` on every shard, and an
    ``Observer(paranoid=True)`` adopting each shard's stats and tracing
    each step as a span (under a fake clock, so the two packages' traces
    compare stamp for stamp), flushed to ``trace_path`` at the end.
    Returns the pool and the per-step decision log, the sanitizer's
    report, the snapshot, the events and the flushed JSONL."""
    import json
    rng = np.random.default_rng(0)
    obs = m.obs.Observer(paranoid=True, clock=_fake_clock())
    sp = _spool(m, num_blocks=64, n_shards=4, block_size=4)
    san = m.refsan.attach(sp)            # per-shard shadow refcounts
    sp.obs = obs
    for i, p in enumerate(sp.shards):
        p.obs = obs
        p.obs_shard = i
        obs.registry.adopt(f"pool.shard{i}", p.stats)
    live, log = [], []
    next_rid = 0

    def soak_step(step: int) -> None:
        nonlocal next_rid
        r = rng.random()
        if r < 0.45 and len(live) < 12:
            n_tokens = int(rng.integers(1, 20))
            n_blocks = -(-n_tokens // 4)
            if not sp.can_reserve(n_blocks):
                log.append(("full", step))
                return
            sp.reserve(n_blocks)
            shard = sp.route(next_rid, f"page{rng.integers(4)}", n_blocks)
            if shard is None:
                sp.cancel_pending(n_blocks)
                log.append(("defer", step))
                return
            t = m.prefix.BlockTable()
            toks = [int(x) for x in rng.integers(0, 99, n_tokens)]
            t.extend(sp.shards[shard], toks, seq_tokens=toks)
            sp.unreserve(n_blocks, rid=next_rid)
            live.append((next_rid, shard, t))
            log.append(("admit", next_rid, shard, list(t.blocks)))
            next_rid += 1
        elif r < 0.65 and live:
            rid, shard, t = live[int(rng.integers(len(live)))]
            if sp.shards[shard].num_free + sp.shards[shard].num_cached > 2:
                f = t.fork(sp.shards[shard])
                live.append((next_rid, shard, f))
                log.append(("fork", rid, next_rid, shard))
                next_rid += 1
        elif live:
            rid, shard, t = live.pop(int(rng.integers(len(live))))
            for b in t.blocks:
                sp.shards[shard].decref(b)
            log.append(("free", rid, shard))

    for step in range(steps):
        with obs.trace.span("soak.step", step=step):
            soak_step(step)
        sp.check_invariants(incremental=True)      # O(dirty), every step
        if step % 25 == 0:
            sp.check_invariants()
        log.append(sp.reserved)
    for rid, shard, t in live:
        for b in t.blocks:
            sp.shards[shard].decref(b)
    sp.check_invariants()
    report = san.report(quiesced=True)
    san.check(quiesced=True)             # no leaks, no double-frees, no UAF
    san.detach()
    events = obs.trace.events()
    n = obs.trace.flush(trace_path)      # drains the ring to JSONL
    with open(trace_path, encoding="utf-8") as fh:
        flushed = [json.loads(line) for line in fh]
    assert n == len(flushed) and obs.trace.events() == []
    return sp, dict(log=log, refsan=report, snapshot=obs.snapshot(),
                    events=events, flushed=flushed)


def test_sharded_soak_admit_fork_free_invariants(tmp_path):
    tsp, out = _both(lambda m: _soak(m, str(tmp_path / f"{id(m)}.jsonl")))
    log, snap, evs = out["log"], out["snapshot"], out["events"]
    assert tsp.num_live == 0 and tsp.reserved == 0
    assert tsp.stats.allocs > 0
    assert sum(p.stats.allocs for p in tsp.shards) == tsp.stats.allocs
    kinds = {e[0] for e in log if isinstance(e, tuple)}
    assert {"admit", "fork", "free"} <= kinds
    assert out["refsan"]["ok"]
    # the adopted per-shard counters are the live stats objects
    for i, p in enumerate(tsp.shards):
        for f in p.stats.fields():
            assert snap["counters"][f"pool.shard{i}.{f}"] == \
                getattr(p.stats, f)
    assert sum(snap["counters"][f"pool.shard{i}.allocs"]
               for i in range(tsp.n_shards)) == tsp.stats.allocs > 0
    # spans wrapped every pool event: 300 step spans at depth 0, every
    # other event stamped inside some step's [ts, ts+dur] window
    steps = [e for e in evs if e["ev"] == "soak.step"]
    assert len(steps) == 300 and all(e["depth"] == 0 for e in steps)
    spans = [(e["ts"], e["ts"] + e["dur_us"]) for e in steps]
    for e in evs:
        if e["ev"] != "soak.step":
            assert any(lo <= e["ts"] <= hi for lo, hi in spans), e
    assert out["flushed"] == evs
    assert sum(1 for e in evs if e["ev"] == "pool.alloc") > 0


def test_incremental_sweep_catches_a_leak():
    """The incremental sweep reads the blocks touched since the last one:
    a block marked used behind the allocator's back fails it."""
    sp = _spool(T, num_blocks=16, n_shards=2)
    t = T.prefix.BlockTable()
    t.extend(sp.shards[0], [1, 2, 3, 4, 5], seq_tokens=[1, 2, 3, 4, 5])
    sp.check_invariants(incremental=True)
    for b in t.blocks:
        sp.shards[0].decref(b)
    sp.shards[0].used[t.blocks[0]] = True            # a leaked block
    with pytest.raises(AssertionError):
        sp.check_invariants(incremental=True)


# ---------------------------------------------------------------------------
# exhaustion isolation
# ---------------------------------------------------------------------------

def test_exhaustion_on_one_shard_rolls_back_and_spares_others():
    jb, tb, jp, tp = _sharded(num_blocks=16, block_size=4)
    for b, p in ((jb, jp), (tb, tp)):
        p0, p1 = b.pool.shards
        b.new_seq(p, list(range(50, 60)), shard=1)
        live1 = p1.num_live
        with pytest.raises(RuntimeError, match="pool exhausted"):
            b.new_seq(p, list(range(1, 41)), shard=0)
        p0.check_invariants()
        p1.check_invariants()
        assert p0.num_live == 0 and p1.num_live == live1
        sid2, _, _ = b.new_seq(p, list(range(1, 9)), shard=0)
        assert b.shard_of(sid2) == 0
    _same_shards(jb.pool, tb.pool)
    assert sorted(tb._seqs.items()) == sorted(jb._seqs.items())
    for b in (jb, tb):
        b.release()
        b.pool.check_invariants()
        assert b.pool.num_live == 0


def test_batch_prefill_exhaustion_rolls_back_across_shards():
    jb, tb, jp, tp = _sharded(num_blocks=8, block_size=4)
    _, tc, _, _ = _model()
    rows = _tokens(0, (3, 9), tc.vocab)
    small = _tokens(1, (2, 4), tc.vocab)
    for b, p in ((jb, jp), (tb, tp)):
        p0, p1 = b.pool.shards
        b.new_seq(p, [1, 2, 3], shard=0)
        live0 = (p0.num_live, p1.num_live)
        with pytest.raises(RuntimeError, match="pool exhausted"):
            b.prefill(p, rows)
        p0.check_invariants()
        p1.check_invariants()
        assert (p0.num_live, p1.num_live) == live0
        assert b._batch == [] and len(b._seqs) == 1
        b.prefill(p, small)
    _same_shards(jb.pool, tb.pool)
    tb.decode_step(tp, torch.ones((2, 1), dtype=torch.int32))
    jb.decode_step(jp, jnp.ones((2, 1), jnp.int32))
    _same_shards(jb.pool, tb.pool)
    for b in (jb, tb):
        b.release()
        b.pool.check_invariants()


def test_make_backend_sharded_sizes_whole_lanes_per_shard():
    from repro.kvcache.backend import make_backend as jmake
    from repro_torch.kvcache.backend import ShardedPagedBackend, \
        make_backend
    from repro_torch.models import lm as tlm
    jc, tc, _, tp = _model()
    for batch, max_seq, n in ((3, 64, 2), (1, 127, 4), (5, 30, 3)):
        be = make_backend(tc, "sharded-paged", batch=batch, max_seq=max_seq,
                          n_shards=n, devices=["cpu"] * n)
        want = jmake(jc, "sharded-paged", batch=batch, max_seq=max_seq,
                     n_shards=n)
        assert isinstance(be, ShardedPagedBackend)
        assert (be.pool.shard_blocks, be.pool.cfg.num_blocks) == \
            (want.pool.shard_blocks, want.pool.cfg.num_blocks)
    assert be.pool.n_shards == 3
    be = make_backend(tc, "sharded-paged", batch=3, max_seq=64, n_shards=2,
                      devices=["cpu"] * 2)
    assert be.pool.shard_blocks == 2 * 5 and be.pool.cfg.num_blocks == 20
    be = make_backend(tc, "sharded-paged", batch=1, max_seq=127,
                      n_shards=4, devices=["cpu"] * 4)
    assert be.pool.shard_blocks == 8
    toks = torch.from_numpy(_tokens(0, (1, 120), tc.vocab))
    tlm.prefill(tp, tc, toks, backend=be)        # must not exhaust
    assert list(be.lengths) == [120]
    be.release()


def test_decode_precheck_is_atomic_across_shards():
    jb, tb, jp, tp = _sharded(num_blocks=8, block_size=4,
                              share_prefixes=False)
    for b, p in ((jb, jp), (tb, tp)):
        s0, _, _ = b.new_seq(p, [1, 2, 3, 4, 5], shard=0)
        s1, _, _ = b.new_seq(p, list(range(10, 18)), shard=1)
        b.new_seq(p, list(range(20, 28)), shard=1)
        before = list(b.table(s0).blocks), b.table(s0).num_tokens
        with pytest.raises(RuntimeError, match="pool exhausted on shard 1"):
            b.decode(p, [s0, s1], [7, 9])
        assert (list(b.table(s0).blocks), b.table(s0).num_tokens) == before
        b.pool.check_invariants()
        b.free_seq(s1)
        lg = b.decode(p, [s0], [7])
        assert lg.shape[0] == 1 and b.table(s0).num_tokens == 6
    _same_shards(jb.pool, tb.pool)
    for b in (jb, tb):
        b.release()


def test_route_with_zero_blocks_keeps_invariants():
    def fn(m):
        sp = _spool(m, num_blocks=8, n_shards=2)
        sp.reserve(0)
        s = sp.route(rid=7, page="zero", n=0)
        assert s is not None and 7 not in sp._rid_reserved
        sp.unreserve(0, rid=7)        # no-op, must not KeyError
        return sp, s
    _both(fn)


def test_batch_api_accepts_empty_batch():
    _, tb, _, tp = _sharded(num_blocks=16, block_size=4)
    _, tc, _, _ = _model()
    lg = tb.prefill(tp, np.zeros((0, 8), np.int32))
    assert tuple(lg.shape) == (0, 1, tc.vocab)
    assert tb.lengths.shape == (0,)
    tb.release()


def test_page_affinity_map_is_bounded():
    cap = tsharded.PAGE_AFFINITY_CAP
    assert cap == jsharded.PAGE_AFFINITY_CAP

    def fn(m):
        sp = _spool(m, num_blocks=1024, n_shards=2)
        out = []
        for i in range(cap + 50):
            sp.reserve(1)
            out.append(sp.route(rid=i, page=f"p{i}", n=1))
            sp.unreserve(1, rid=i)
        assert len(sp._page_shard) == cap
        assert "p0" not in sp._page_shard and f"p{cap + 49}" in sp._page_shard
        return sp, out
    _both(fn)


# ---------------------------------------------------------------------------
# engine end-to-end over shards
# ---------------------------------------------------------------------------

def test_engine_sharded_serving_matches_jax_engine():
    """Continuous batching over a 2-shard pool: the port's engine serves
    the JAX engine's tokens (float32, same converted weights), with the
    same routing, shard defers, claims and engine and pool stats."""
    from repro.kvcache.backend import ShardedPagedBackend as JSharded
    from repro.serve import engine as jengine
    from repro_torch.kvcache.backend import ShardedPagedBackend as TSharded
    from repro_torch.serve import engine as tengine
    jc, tc, jp, tp = _model()
    rng = np.random.default_rng(3)
    shared = tuple(int(t) for t in rng.integers(1, tc.vocab, 16))
    prompts = [shared + tuple(int(t) for t in rng.integers(1, tc.vocab, 2))
               for _ in range(4)]
    prompts += [tuple(int(t) for t in rng.integers(1, tc.vocab, 18))
                for _ in range(2)]
    engines, outs = [], []
    for b, p, c, sched, eng_mod in (
            (JSharded(jc, n_shards=2, num_blocks=96, block_size=8,
                      decode_mode="gather"), jp, jc, jsched, jengine),
            (TSharded(tc, n_shards=2, num_blocks=96, block_size=8,
                      decode_mode="kernel", devices=["cpu", "cpu"]),
             tp, tc, tsched, tengine)):
        eng = eng_mod.ServeEngine(b.pool, sched.MarsScheduler(pool=b.pool),
                                  eng_mod.PagedLM(p, c, b), max_lanes=3)
        reqs = [sched.Request(rid=i, prompt=q, arrival=i * 1e-3,
                              prefix_len=8, max_new=4)
                for i, q in enumerate(prompts)]
        outs.append(eng.run(reqs))
        engines.append(eng)
    assert outs[1] == outs[0] and sorted(outs[1]) == list(range(6))
    je, te = engines
    assert te.stats.as_dict() == je.stats.as_dict()
    assert te.scheduler.stats.as_dict() == je.scheduler.stats.as_dict()
    _same_shards(je.pool, te.pool)
    assert te.pool.stats.prefix_hits > 0
    te.pool.check_invariants()
    assert te.pool.num_live == 0 and te.pool.reserved == 0


def test_engine_sharded_serving_matches_dense_greedy():
    """The port's sharded engine emits the port's dense greedy tokens."""
    from repro_torch.kvcache.backend import ShardedPagedBackend
    from repro_torch.serve.engine import PagedLM, ServeEngine
    from repro_torch.serve.step import greedy_generate
    _, tc, _, tp = _model()
    backend = ShardedPagedBackend(tc, n_shards=2, num_blocks=96,
                                  block_size=8, decode_mode="kernel",
                                  devices=["cpu", "cpu"])
    eng = ServeEngine(backend.pool, tsched.MarsScheduler(pool=backend.pool),
                      PagedLM(tp, tc, backend), max_lanes=3)
    rng = np.random.default_rng(3)
    prompts = [tuple(int(t) for t in rng.integers(1, tc.vocab, 18))
               for _ in range(4)]
    out = eng.run([tsched.Request(rid=i, prompt=p, arrival=i * 1e-3,
                                  prefix_len=8, max_new=4)
                   for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        want = greedy_generate(tp, tc, torch.tensor([p], dtype=torch.int32),
                               4, max_seq=len(p) + 5)
        assert out[i][0] == want[0].tolist(), f"lane {i} diverged"
    backend.pool.check_invariants()


def test_batch_lane_order_keeps_shards_distinct():
    from repro.kernels.paged_attention import ops as jops
    from repro_torch.kernels.paged_attention import ops as tops
    tables = [tprefix.BlockTable(blocks=[b], num_tokens=4) for b in (0, 1, 2)]
    order = tops.batch_lane_order(tables, blocks_per_group=8,
                                  shard_ids=[0, 1, 0])
    grouped = [[0, 1, 0][i] for i in order]
    assert grouped in ([0, 0, 1], [1, 0, 0])
    assert list(tops.batch_lane_order(tables, 8)) == [0, 1, 2]
    jtables = [jprefix.BlockTable(blocks=[b], num_tokens=4)
               for b in (0, 1, 2)]
    assert list(order) == list(jops.batch_lane_order(
        jtables, blocks_per_group=8, shard_ids=[0, 1, 0]))
