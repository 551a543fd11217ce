"""Port of ``tests/test_traffic_classes.py``: traffic-class scheduling
under overload (SMS staged admission: per-class quotas, queue depths,
latency-first with an aging escape hatch), the preemption hint, decode
preemption (pause -> demote -> bitwise resume, single and sharded,
gather and kernel decode), per-class wait accounting and the 500-step
overload soak with the refcount sanitizer attached, each held against
the JAX package.

Every reference test has a port test here by the same name, with its
parametrisation and its hypothesis settings, and keeps every assertion
the reference makes, asserted on the port.  Each also runs the same
seeded traffic through the JAX package and holds the port to it:
- host decisions bitwise (ROADMAP's first parity tier): per request the
  same outcome and the same reject reason, the same batches in order,
  the same preemption hints, class counters and wait histograms;
- the pause/resume and engine tests run the port's ``PagedBackend`` /
  ``PagedLM`` on the qwen1.5-0.5b smoke config's JAX init converted
  (``convert.py``): the port's tokens equal the JAX package's and the
  port's own never-paused control's.  Both run the smoke config in
  float32 (ROADMAP's second parity tier), not the reference's bf16: in
  bf16 the random init's top logits lie within a bf16 spacing of each
  other (0.3945 and 0.3965 after the rollback test's resume), so the two
  frameworks' roundings pick different argmaxes though each package's
  paused run equals its own control bitwise.  The JAX side decodes
  through its gather oracle (``decode_mode="gather"``) whatever the
  port's mode: its Pallas kernel runs only in interpret mode here;
- the soak's JAX engine runs the reference's own toy oracle
  (``paged_attention_ref``) under ``jax.jit`` (the same function; eager,
  it takes most of a minute on the CPU).

No port test covered these before: ``test_scheduler_differential``
(``tests/test_torch_scheduler.py``) drives ``default_classes(3)`` with
random traffic, and the ``--classes 3`` case of
``test_serve_main_paged_tiered_and_sharded_match_jax_main``
(``tests/test_torch_serve.py``) and ``test_resume_through_the_tiers_is_
bitwise`` (``tests/test_torch_tiers.py``) touch the same code, but none
pins the behaviours below.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # hypothesis is optional in CI
    st = None

from repro import configs as jconfigs  # noqa: E402
from repro.analysis import refsan as jrefsan  # noqa: E402
from repro.kvcache import pool as jpool  # noqa: E402
from repro.kvcache import backend as jbackend  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import refsan as trefsan  # noqa: E402
from repro_torch.kvcache import backend as tbackend  # noqa: E402
from repro_torch.kvcache import pool as tpool  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

ARCH = "qwen1_5_0_5b"

# The two packages: their modules and how each places a backend (the
# port's on the CPU; the JAX side's decode is always its gather oracle).
J = types.SimpleNamespace(name="jax", sched=jsched, pool=jpool,
                          backend=jbackend, engine=jengine, refsan=jrefsan,
                          dev=lambda n=None: {}, mode=lambda m: "gather",
                          toy_dev={})
T = types.SimpleNamespace(name="port", sched=tsched, pool=tpool,
                          backend=tbackend, engine=tengine, refsan=trefsan,
                          dev=lambda n=None: {"device": "cpu"} if n is None
                          else {"devices": ["cpu"] * n},
                          mode=lambda m: m, toy_dev={"device": "cpu"})
SIDES = (J, T)

F32 = dict(param_dtype="float32", compute_dtype="float32")
_MODEL: dict = {}


def _model(side):
    """(cfg, params) of the qwen smoke config in float32: the JAX init,
    and on the port's side that init converted (cached)."""
    if not _MODEL:
        jc = dataclasses.replace(jconfigs.get_smoke(ARCH), **F32)
        tc = dataclasses.replace(tconfigs.get_smoke(ARCH), **F32)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       "cpu")
        _MODEL.update(jax=(jc, jp), port=(tc, tp))
    return _MODEL[side.name]


def _greedy(logits) -> list:
    return [int(np.argmax(np.asarray(lg, np.float32))) for lg in logits]


def _req(side, rid, prompt, *, cls="default", arrival=0.0, max_new=4):
    return side.sched.Request(rid=rid, prompt=tuple(prompt), arrival=arrival,
                              prefix_len=4, max_new=max_new,
                              traffic_class=cls)


def _prefix(i):
    return (i * 10 + 1, i * 10 + 2, i * 10 + 3, i * 10 + 4)


def _both(scenario):
    """``scenario(side)`` on the JAX package and on the port; the port's
    record must equal the reference's."""
    want, got = (scenario(side) for side in SIDES)
    assert got == want
    return got


def _class_record(sched) -> dict:
    return {c: (s.as_dict(), sched.wait_hist[c].to_snapshot())
            for c, s in sched.class_stats.items()}


# ---------------------------------------------------------------------------
# SMS stage 2: class-aware batch scheduling policy
# ---------------------------------------------------------------------------

def _classed_sched(side, **kw):
    S = side.sched
    return S.MarsScheduler(classes=(
        S.TrafficClass("interactive", latency=True),
        S.TrafficClass("batch", quota=2, max_age=8.0),
    ), **kw)


def test_latency_class_scheduled_ahead_of_older_batch():
    def scenario(side):
        sched = _classed_sched(side)
        for i in range(3):                   # batch arrives FIRST
            assert sched.offer(_req(side, i, _prefix(i) + (1,), cls="batch",
                                    arrival=0.0))
        assert sched.offer(_req(side, 9, _prefix(9) + (1,),
                                cls="interactive", arrival=1.0))
        out = sched.schedule_batch(8, now=2.0)
        assert [r.rid for r in out][0] == 9
        # stage-1 quota: at most 2 batch admissions rode along
        assert sum(r.traffic_class == "batch" for r in out) == 2
        assert len(sched) == 1               # the third batch req waits
        return [r.rid for r in out], _class_record(sched)
    _both(scenario)


def test_quota_zero_means_unbounded():
    def scenario(side):
        S = side.sched
        sched = S.MarsScheduler(classes=(S.TrafficClass("bulk", quota=0),))
        for i in range(6):
            assert sched.offer(_req(side, i, _prefix(i % 2) + (i,),
                                    cls="bulk"))
        out = sched.schedule_batch(16, now=1.0)
        assert len(out) == 6
        return [r.rid for r in out], _class_record(sched)
    _both(scenario)


def test_aging_escape_hatch_beats_latency_first():
    """A batch request older than max_age drains ahead of the latency
    class — SMS's no-starvation bound on bandwidth streams."""
    def scenario(side):
        sched = _classed_sched(side)
        assert sched.offer(_req(side, 0, _prefix(0) + (1,), cls="batch",
                                arrival=0.0))
        assert sched.offer(_req(side, 1, _prefix(1) + (1,),
                                cls="interactive", arrival=8.5))
        out = sched.schedule_batch(8, now=9.0)  # batch head aged 9.0 >= 8.0
        assert [r.rid for r in out] == [0, 1]
        return [r.rid for r in out], _class_record(sched)
    _both(scenario)


def test_class_queue_depth_backpressure():
    def scenario(side):
        S = side.sched
        sched = S.MarsScheduler(classes=(S.TrafficClass("bulk",
                                                        queue_depth=2),))
        got = [sched._offer(_req(side, 0, _prefix(0) + (1,), cls="bulk")),
               sched._offer(_req(side, 1, _prefix(1) + (2,), cls="bulk")),
               sched._offer(_req(side, 2, _prefix(2) + (3,), cls="bulk"))]
        assert got[:2] == [(True, "ok")] * 2
        assert got[2] == (False, "class_depth")
        assert sched.class_stats["bulk"].reject == 1
        return got, _class_record(sched)
    _both(scenario)


def test_latency_capacity_bounce_raises_preempt_hint():
    def scenario(side):
        pool = side.pool.BlockPool(side.pool.PoolConfig(num_blocks=2,
                                                        block_size=4))
        sched = _classed_sched(side, pool=pool)
        got = [sched._offer(_req(side, 0, _prefix(0) + (1, 2), cls="batch",
                                 max_new=8))]
        assert got[0] == (False, "pool_capacity")
        got.append(sched.take_preempt_hint())  # throughput bounce: no hint
        assert not got[-1]
        got.append(sched._offer(_req(side, 1, _prefix(1) + (1, 2),
                                     cls="interactive", max_new=8)))
        assert got[-1] == (False, "pool_capacity")
        got.append(sched.take_preempt_hint())  # latency bounce: hint raised
        assert got[-1]
        got.append(sched.take_preempt_hint())  # ...and consumed once
        assert not got[-1]
        return got, _class_record(sched)
    _both(scenario)


def test_unknown_traffic_class_falls_back_to_default_stream():
    def scenario(side):
        sched = _classed_sched(side)
        assert sched.offer(_req(side, 0, _prefix(0) + (1,),
                                cls="no-such-class"))
        out = sched.schedule_batch(4, now=1.0)
        assert [r.rid for r in out] == [0]
        assert sched.class_stats["interactive"].admit == 1
        return [r.rid for r in out], _class_record(sched)
    _both(scenario)


# ---------------------------------------------------------------------------
# per-class wait accounting (regression: the old aggregate mean let a
# deferred batch request inflate the interactive latency numbers)
# ---------------------------------------------------------------------------

def test_deferred_batch_wait_cannot_inflate_interactive_histogram():
    def scenario(side):
        sched = _classed_sched(side)
        assert sched.offer(_req(side, 0, _prefix(0) + (1,),
                                cls="interactive", arrival=0.0))
        assert sched.offer(_req(side, 1, _prefix(1) + (1,), cls="batch",
                                arrival=0.0))
        out = sched.schedule_batch(1, now=1.0)   # budget 1: interactive
        assert [r.rid for r in out] == [0]
        ih, bh = sched.wait_hist["interactive"], sched.wait_hist["batch"]
        i_p99_before = ih.quantile(0.99)
        i_wait_before = sched.class_stats["interactive"].wait_sum
        # the batch request sits for 99 more fake-clock seconds, then drains
        out = sched.schedule_batch(4, now=100.0)
        assert [r.rid for r in out] == [1]
        # its 100s wait landed in the batch stream only
        assert sched.class_stats["batch"].wait_sum == pytest.approx(100.0)
        assert bh.quantile(0.50) >= 1e4          # ms
        # ...and the interactive stream is untouched, bitwise
        assert ih.quantile(0.99) == i_p99_before
        assert sched.class_stats["interactive"].wait_sum == i_wait_before
        assert sched.class_stats["interactive"].mean_wait == \
            pytest.approx(1.0)
        # the aggregate stays a capacity summary over ALL classes (and so
        # it does move)
        assert sched.stats.mean_wait == pytest.approx((1.0 + 100.0) / 2)
        return (bh.quantile(0.50), ih.quantile(0.99), sched.stats.as_dict(),
                _class_record(sched))
    _both(scenario)


# ---------------------------------------------------------------------------
# decode preemption: pause -> demote -> bitwise resume (backend level)
# ---------------------------------------------------------------------------

def _build_pair(side, prompts, decode_mode, sharded, num_blocks=64, **kw):
    """Two identical backends + their sids (control, candidate)."""
    cfg, params = _model(side)
    B = side.backend
    out = []
    for _ in range(2):
        if sharded:
            b = B.ShardedPagedBackend(cfg, n_shards=2, num_blocks=num_blocks,
                                      block_size=4,
                                      decode_mode=side.mode(decode_mode),
                                      **side.dev(2), **kw)
            sids = [b.new_seq(params, p, shard=i % 2)[0]
                    for i, p in enumerate(prompts)]
        else:
            kw.setdefault("share_prefixes", False)
            b = B.PagedBackend(cfg, num_blocks=num_blocks, block_size=4,
                               decode_mode=side.mode(decode_mode),
                               **side.dev(), **kw)
            sids = [b.new_seq(params, p)[0] for p in prompts]
        out.append((b, sids))
    return out


def _step_lanes(params, b, sids, toks, lanes):
    """One committed decode round for the given lane subset."""
    lg = b.decode(params, [sids[i] for i in lanes],
                  [toks[i][-1] for i in lanes])
    for i, t in zip(lanes, _greedy(lg)):
        toks[i].append(t)


@pytest.mark.parametrize("decode_mode", ["gather", "kernel"])
@pytest.mark.parametrize("sharded", [False, True])
def test_pause_resume_round_trip_is_bitwise(decode_mode, sharded):
    """pause_seq captures the victim's KV verbatim and releases its blocks
    to evictable cache; resume_seq restores it with zero recompute.  The
    control runs the IDENTICAL decode schedule (same lane sets per round)
    without ever pausing — so any token difference is state the round
    trip failed to preserve."""
    def scenario(side):
        _, params = _model(side)
        prompts = [list(range(1, 9)), list(range(20, 31))]
        (ctl, ctl_sids), (pre, pre_sids) = _build_pair(
            side, prompts, decode_mode, sharded)
        toks_c = [list(p) for p in prompts]
        toks_p = [list(p) for p in prompts]
        for lanes in [[0, 1], [0, 1]]:       # joint warm-up
            _step_lanes(params, ctl, ctl_sids, toks_c, lanes)
            _step_lanes(params, pre, pre_sids, toks_p, lanes)
        free0 = pre.pool.num_free + pre.pool.num_cached
        rec = pre.pause_seq(pre_sids[0])
        # the demotion is real: the victim's blocks are reclaimable now
        freed = pre.pool.num_free + pre.pool.num_cached
        assert freed > free0
        for lanes in ([1], [1]):             # survivor decodes alone
            _step_lanes(params, ctl, ctl_sids, toks_c, lanes)
            _step_lanes(params, pre, pre_sids, toks_p, lanes)
        pre_sids[0] = pre.resume_seq(rec)
        for lanes in ([0], [0], [0, 1]):     # catch up, then rejoin
            _step_lanes(params, ctl, ctl_sids, toks_c, lanes)
            _step_lanes(params, pre, pre_sids, toks_p, lanes)
        assert toks_p[0] == toks_c[0]
        assert toks_p[1] == toks_c[1]
        want_num = ctl.table(ctl_sids[0]).num_tokens
        for (b, sids) in ((ctl, ctl_sids), (pre, pre_sids)):
            assert b.table(sids[0]).num_tokens == want_num
            b.pool.check_invariants()
            b.release()
        return toks_p, (free0, freed), rec["num_tokens"]
    _both(scenario)


def test_pause_demote_to_tier_resume_promotes():
    """The paused sequence's released blocks can spill all the way to the
    host tier under pool pressure; resume promotes them back through
    ``TierManager.match`` and the token stream is still bitwise."""
    def scenario(side):
        cfg, params = _model(side)
        prompts = [list(range(1, 9))]
        (ctl, ctl_sids), (pre, pre_sids) = _build_pair(
            side, prompts, "gather", False, num_blocks=16, tiered=True,
            share_prefixes=True)
        toks_c = [list(prompts[0])]
        toks_p = [list(prompts[0])]
        for _ in range(2):
            _step_lanes(params, ctl, ctl_sids, toks_c, [0])
            _step_lanes(params, pre, pre_sids, toks_p, [0])
        rec = pre.pause_seq(pre_sids[0])
        # pressure: churn big throwaway sequences until eviction demotes
        # the paused blocks out of the pool into the host tier.  The
        # reference's filler ids run to 339, past the smoke vocabulary of
        # 256: its gather clamps them, the port's embedding refuses them,
        # so here they wrap into the vocabulary (their values only fill)
        for i in range(4):
            filler = [t % cfg.vocab
                      for t in range(100 + 60 * i, 160 + 60 * i)]
            fsid, _, _ = pre.new_seq(params, filler)
            pre.free_seq(fsid)
        demotes = pre.tiers.stats.demotes
        assert demotes > 0, "pressure never demoted the paused blocks"
        promotes0 = pre.tiers.stats.promotes
        pre_sids[0] = pre.resume_seq(rec)
        promotes = pre.tiers.stats.promotes
        assert promotes > promotes0
        for _ in range(2):
            _step_lanes(params, ctl, ctl_sids, toks_c, [0])
            _step_lanes(params, pre, pre_sids, toks_p, [0])
        assert toks_p[0] == toks_c[0]
        pre.pool.check_invariants()
        ctl.release()
        pre.release()
        return toks_p, demotes, promotes0, promotes
    _both(scenario)


def test_resume_rolls_back_cleanly_on_exhausted_pool():
    def scenario(side):
        cfg, params = _model(side)
        b = side.backend.PagedBackend(cfg, num_blocks=6, block_size=4,
                                      decode_mode="gather",
                                      share_prefixes=False, **side.dev())
        sid, _, _ = b.new_seq(params, list(range(1, 9)))     # 2 blocks
        rec = b.pause_seq(sid)
        hog, _, _ = b.new_seq(params, list(range(20, 40)))   # 5 blocks
        free0, cached0 = b.pool.num_free, b.pool.num_cached
        with pytest.raises(RuntimeError, match="pool exhausted"):
            b.resume_seq(rec)
        assert (b.pool.num_free, b.pool.num_cached) == (free0, cached0)
        b.pool.check_invariants()
        b.free_seq(hog)
        sid2 = b.resume_seq(rec)             # headroom back: resume works
        assert b.table(sid2).num_tokens == rec["num_tokens"]
        toks = _greedy(b.decode(params, [sid2], [7]))
        b.release()
        return free0, cached0, rec["num_tokens"], toks
    _both(scenario)


# ---------------------------------------------------------------------------
# property: pause/resume placement never changes tokens
# ---------------------------------------------------------------------------

if st is not None:
    @settings(max_examples=6, deadline=None)
    @given(st.integers(1, 3),                    # pause point (decode steps)
           st.integers(1, 2),                    # paused rounds
           st.sampled_from([1, 2]),              # shard count
           st.sampled_from(["gather", "kernel"]),
           st.integers(0, 10_000))               # prompt seed
    def test_pause_placement_never_changes_tokens(pause_at, down, n_shards,
                                                  decode_mode, seed):
        """Wherever the pause lands in the decode stream, however long
        the sequence stays demoted, and whichever shard it lives on, the
        resumed lane's tokens are the never-paused control's, bitwise,
        and the JAX package's."""
        def scenario(side):
            cfg, params = _model(side)
            rng = np.random.default_rng(seed)
            prompts = [[int(t) for t in rng.integers(1, cfg.vocab, ln)]
                       for ln in rng.integers(5, 13, size=2)]
            (ctl, ctl_sids), (pre, pre_sids) = _build_pair(
                side, prompts, decode_mode, n_shards == 2)
            toks_c = [list(p) for p in prompts]
            toks_p = [list(p) for p in prompts]
            schedule = [[0, 1]] * pause_at + [["pause"]] + [[1]] * down \
                + [["resume"]] + [[0]] * down + [[0, 1]]
            for lanes in schedule:
                if lanes == ["pause"]:
                    rec = pre.pause_seq(pre_sids[0])
                elif lanes == ["resume"]:
                    pre_sids[0] = pre.resume_seq(rec)
                else:
                    _step_lanes(params, ctl, ctl_sids, toks_c, lanes)
                    _step_lanes(params, pre, pre_sids, toks_p, lanes)
            assert toks_p == toks_c
            ctl.release()
            pre.release()
            return toks_p
        _both(scenario)
else:
    def test_pause_placement_never_changes_tokens():
        pytest.importorskip("hypothesis")


# ---------------------------------------------------------------------------
# engine-level preemption under overload (PagedLM)
# ---------------------------------------------------------------------------

def _lm_engine(side, *, shards, num_blocks, max_lanes=4, classes=None):
    cfg, params = _model(side)
    B = side.backend
    if shards > 1:
        backend = B.ShardedPagedBackend(cfg, n_shards=shards,
                                        num_blocks=num_blocks, block_size=16,
                                        decode_mode="gather",
                                        **side.dev(shards))
    else:
        backend = B.PagedBackend(cfg, num_blocks=num_blocks, block_size=16,
                                 decode_mode="gather", **side.dev())
    pool = backend.pool
    sched = side.sched.MarsScheduler(pool=pool, classes=classes)
    eng = side.engine.ServeEngine(pool, sched,
                                  side.engine.PagedLM(params, cfg, backend),
                                  max_lanes=max_lanes)
    return eng, sched


def _solo_tokens(side, prompt, max_new):
    """The request served alone on an uncontended engine — the bitwise
    reference for whatever batching/preemption the overloaded run did."""
    eng, _ = _lm_engine(side, shards=1, num_blocks=64)
    got = eng.run([_req(side, 0, prompt, max_new=max_new)])
    eng.model.backend.release()
    return got[0][0]


@pytest.mark.parametrize("shards", [1, 2])
def test_engine_preempts_batch_and_stays_bitwise(shards):
    """Overload with long batch decodes resident: interactive arrivals
    bounce on capacity, the engine pauses a batch decode (freeing its
    blocks), serves the interactive burst, resumes the victim — and every
    request's tokens equal its solo, never-preempted run (the port's solo
    runs; the JAX package's overloaded run gives the same tokens and the
    same class counts)."""
    def scenario(side):
        # 8 blocks total (4 per shard when sharded): the two resident
        # batch decodes hold 6, so the interactive burst must bounce
        eng, sched = _lm_engine(side, shards=shards, num_blocks=8,
                                classes=side.sched.default_classes(2))
        batch = [_req(side, i, _prefix(i) + tuple(range(5, 25)),
                      cls="batch", arrival=0.0, max_new=24)
                 for i in range(2)]
        chat = [_req(side, 10 + i, _prefix(6) + (40 + i,),
                     cls="interactive", arrival=2.0, max_new=4)
                for i in range(6)]
        pending = batch + chat
        for step in range(400):
            now = float(step)
            pending = [r for r in pending
                       if r.arrival > now or not eng.submit(r)]
            eng.step(now=now)
            if not pending and not eng.running and not eng.paused \
                    and not len(sched):
                break
        else:
            pytest.fail("overloaded engine did not drain")
        assert sched.class_stats["batch"].preempt >= 1
        assert eng.paused == []
        if side is T:
            for r in batch + chat:
                want = _solo_tokens(side, r.prompt, r.max_new)
                assert eng.finished[r.rid] == [want], f"rid {r.rid} diverged"
        eng.pool.check_invariants()
        eng.model.backend.release()
        return dict(eng.finished), step, _class_record(sched)
    _both(scenario)


def test_preemption_is_noop_without_latency_pressure():
    """Same engine, no interactive traffic: nothing is ever paused."""
    def scenario(side):
        eng, sched = _lm_engine(side, shards=1, num_blocks=16,
                                classes=side.sched.default_classes(2))
        reqs = [_req(side, i, _prefix(i % 3) + (i,), cls="batch",
                     max_new=4) for i in range(6)]
        out = eng.run(reqs)
        assert all(cs.preempt == 0 for cs in sched.class_stats.values())
        eng.model.backend.release()
        return out, _class_record(sched)
    _both(scenario)


# ---------------------------------------------------------------------------
# overload soak: 500 mixed-class steps at ~2x pool capacity
# ---------------------------------------------------------------------------

def _soak(side):
    """The reference's soak on one package; returns each offer's arrival,
    class and outcome (served at a step, or its reject reason) and the
    class counters."""
    P = side.pool
    pool = P.BlockPool(P.PoolConfig(num_blocks=32, block_size=4,
                                    n_kv_heads=2, head_dim=64))
    sched = side.sched.MarsScheduler(pool=pool,
                                     classes=side.sched.default_classes(3))
    eng = side.engine.ServeEngine(pool, sched, max_lanes=4, **side.toy_dev)
    san = side.refsan.attach(pool)
    rng = np.random.default_rng(7)
    spec = {"interactive": (1, 2), "batch": (8, 10), "stream": (4, 6)}
    arrivals, outcomes = {}, {}
    rid = 0
    steps = 500
    try:
        for step in range(steps + 200):      # 500 offered + drain tail
            now = float(step)
            if step < steps:
                for cls in ("interactive", "batch", "interactive",
                            "stream")[: 2 + step % 3]:
                    tail, max_new = spec[cls]
                    prompt = _prefix(int(rng.integers(0, 4))) \
                        + tuple(int(t) for t in rng.integers(50, 99, tail))
                    r = _req(side, rid, prompt, cls=cls, arrival=now,
                             max_new=max_new)
                    ok, reason = sched._offer(r)
                    arrivals[rid] = (now, cls)
                    if ok:
                        outcomes[rid] = "accepted"
                    else:
                        assert reason in ("queue_full", "class_depth",
                                          "pool_capacity", "page_ways")
                        outcomes[rid] = reason
                    rid += 1
            eng.step(now=now)
            for fid in eng.finished:
                if outcomes.get(fid) == "accepted":
                    outcomes[fid] = ("served", now)
            if step % 8 == 0:
                pool.check_invariants()
                assert san.findings == [], \
                    [f.msg for f in san.findings[:5]]
            if step >= steps and not eng.running \
                    and not len(sched):
                break
        else:
            pytest.fail("soak did not drain after offers stopped")
        san.check(quiesced=True)             # nothing leaked
    finally:
        san.detach()
    pool.check_invariants()
    return arrivals, outcomes, rid, _class_record(sched)


def test_overload_soak_no_starvation_latency_ordering(monkeypatch):
    """Sustained 2x-capacity mixed traffic through the toy engine with the
    refcount sanitizer shadowing every pool op: every offered request
    either serves or rejects with a named reason (no silent starvation),
    pool invariants hold throughout, and the class-aware scheduler keeps
    interactive p99 under batch p99 on the fake clock.  The JAX package's
    engine on the same traffic gives every request the same outcome."""
    monkeypatch.setattr(jengine, "paged_attention_ref",
                        jax.jit(jengine.paged_attention_ref))
    arrivals, outcomes, rid, classes = _both(_soak)
    # no starvation: every accepted request was served
    stuck = [r for r, o in outcomes.items() if o == "accepted"]
    assert stuck == [], f"{len(stuck)} accepted requests never served"
    assert rid > 800                         # the load was real...
    rejected = sum(1 for o in outcomes.values() if isinstance(o, str))
    assert rejected > 100                    # ...and actually overloaded
    lat = {"interactive": [], "batch": []}
    for r, o in outcomes.items():
        _, cls = arrivals[r]
        if isinstance(o, tuple) and cls in lat:
            lat[cls].append(o[1] - arrivals[r][0])
    assert len(lat["interactive"]) > 50 and len(lat["batch"]) > 50
    assert np.percentile(lat["interactive"], 99) \
        < np.percentile(lat["batch"], 99)
