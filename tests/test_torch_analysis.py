"""Differential tests of the port's protocol sanitizers
(``repro_torch.analysis``) against the JAX package's: the 25 race-detector
and refcount-sanitizer cases of ``tests/test_analysis.py`` (its six lint
cases wait for the port of ``analysis.lint``).

The race detector is stdlib code in both packages: every history, every
interleaving of per-shard chains and every replayed trace goes through
both checkers, which must report the same violations (codes, shards,
steps, stream positions and messages) and the same stats.  The refcount
sanitizer runs on the port's pools (torch KV buffers included) and must
report what the reference's reports on the reference's pools for the same
operations: kinds, blocks, generations, operations and call-site
provenance, which names the caller's file (never the port's pool or the
sanitizer itself)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import races as jraces  # noqa: E402
from repro.analysis import refsan as jrefsan  # noqa: E402
from repro.kvcache import pool as jpool  # noqa: E402
from repro.kvcache import sharded_pool as jsharded  # noqa: E402
from repro_torch.analysis import races as traces  # noqa: E402
from repro_torch.analysis import refsan as trefsan  # noqa: E402
from repro_torch.kvcache import pool as tpool  # noqa: E402
from repro_torch.kvcache import sharded_pool as tsharded  # noqa: E402


def _ev(m, e):
    return m.Ev(e.kind, e.shard, e.step, e.round)


def _check(history, **kw):
    """The port checker's violations on ``history`` (port ``Ev``s), held
    to the reference checker's on the same events."""
    got = traces.check_history(history, **kw)
    want = jraces.check_history([_ev(jraces, e) for e in history], **kw)
    assert [v.to_dict() for v in got] == [v.to_dict() for v in want]
    return got


def _codes(history) -> set:
    return {v.code for v in _check(history)}


# ---------------------------------------------------------------------------
# race detector: in-process interleavings
# ---------------------------------------------------------------------------

def test_legal_chains_accept_every_interleaving():
    c0, c1 = traces.shard_chain(0, 2), traces.shard_chain(1, 2)
    jc0, jc1 = jraces.shard_chain(0, 2), jraces.shard_chain(1, 2)
    assert [_ev(jraces, e) for e in c0] == jc0
    n = 0
    for il, jil in zip(traces.interleavings(c0, c1),
                       jraces.interleavings(jc0, jc1)):
        n += 1
        assert [_ev(jraces, e) for e in il] == jil
        assert traces.check_history(il) == []
        assert jraces.check_history(jil) == []
    # C(16, 8): both chains' relative orders preserved, all merges seen
    assert n == 12870


def _swap_sync_commit(chain):
    mut = list(chain)
    si = next(i for i, e in enumerate(mut)
              if e.kind == "sync" and e.step == 1)
    ci = next(i for i, e in enumerate(mut)
              if e.kind == "commit" and e.step == 1)
    mut[si], mut[ci] = mut[ci], mut[si]
    return mut


def test_seeded_commit_before_sync_caught_in_every_interleaving():
    mut = _swap_sync_commit(traces.shard_chain(0, 2))
    seen = 0
    for il in traces.interleavings(mut, traces.shard_chain(1, 1)):
        seen += 1
        assert "commit-before-sync" in _codes(il)
    assert seen > 100


def test_seeded_fork_without_flush_caught_in_every_interleaving():
    mut = list(traces.shard_chain(0, 2))
    si = next(i for i, e in enumerate(mut)
              if e.kind == "sync" and e.step == 1)
    mut.insert(si, traces.Ev("fork", 0))   # fork lands mid-step: no barrier
    for il in traces.interleavings(mut, traces.shard_chain(1, 1)):
        assert "barrier-missed" in _codes(il)


def test_barrier_between_steps_is_legal():
    Ev = traces.Ev
    evs = traces.shard_chain(0, 1) + [Ev("fork", 0), Ev("free", 0)] \
        + [Ev("dispatch", 0, 1), Ev("sync", 0, 1), Ev("commit", 0, 1)]
    assert _check(evs) == []


def test_double_dispatch_and_lag_exceeded():
    Ev = traces.Ev
    assert {"double-dispatch"} <= _codes([Ev("dispatch", 0, 0),
                                          Ev("dispatch", 0, 1)])
    assert "lag-exceeded" in _codes(
        [Ev("dispatch", 0, 0), Ev("sync", 0, 0), Ev("dispatch", 0, 1),
         Ev("sync", 0, 1)])


def test_lost_commit_flagged_at_stream_end():
    Ev = traces.Ev
    assert [v.code for v in _check([Ev("dispatch", 0, 0),
                                    Ev("sync", 0, 0)])] == ["lost-commit"]


def test_pause_between_steps_is_legal_in_every_interleaving():
    Ev = traces.Ev
    c0 = traces.shard_chain(0, 1) + [Ev("pause", 0), Ev("resume", 0)] \
        + [Ev("dispatch", 0, 1), Ev("sync", 0, 1), Ev("commit", 0, 1)]
    n = 0
    for il in traces.interleavings(c0, traces.shard_chain(1, 1)):
        n += 1
        assert _check(il) == []
    assert n > 100


@pytest.mark.parametrize("where", ["inflight", "pending"])
def test_seeded_pause_inside_pipeline_caught_everywhere(where):
    mut = list(traces.shard_chain(0, 2))
    kind = "sync" if where == "inflight" else "commit"
    at = next(i for i, e in enumerate(mut) if e.kind == kind and e.step == 1)
    mut.insert(at, traces.Ev("pause", 0))
    for il in traces.interleavings(mut, traces.shard_chain(1, 1)):
        codes = _codes(il)
        assert "preempt-during-dispatch" in codes
        assert "barrier-missed" not in codes     # pause has its OWN code


def test_resume_is_a_flush_barrier():
    Ev = traces.Ev
    assert "barrier-missed" in _codes([Ev("dispatch", 0, 0),
                                       Ev("sync", 0, 0), Ev("resume", 0)])


def test_issue_then_gather_round_ordering():
    Ev = traces.Ev
    good = [Ev("dispatch", 0, 0, round=0), Ev("dispatch", 1, 0, round=0),
            Ev("sync", 0, 0, round=0), Ev("sync", 1, 0, round=0),
            Ev("commit", 0, 0), Ev("commit", 1, 0)]
    assert _check(good) == []
    bad = [Ev("dispatch", 0, 0, round=0), Ev("sync", 0, 0, round=0),
           Ev("dispatch", 1, 0, round=0), Ev("sync", 1, 0, round=0),
           Ev("commit", 0, 0), Ev("commit", 1, 0)]
    assert "gather-before-issue" in _codes(bad)
    with pytest.raises(ValueError, match="unknown event kind"):
        traces.check_history([Ev("teleport", 0)])


# ---------------------------------------------------------------------------
# race detector: trace replay
# ---------------------------------------------------------------------------

def _trace(steps=3, shard=0, t0=0):
    """A legal pipelined TraceLog slice: commit of step k emitted at
    dispatch of step k+1 (the one-step lag), token after each sync."""
    evs, ts = [], t0
    for k in range(steps):
        if k > 0:
            evs.append({"ts": ts, "ev": "backend.commit", "shard": shard,
                        "step": k - 1})
            ts += 1
        evs.append({"ts": ts, "ev": "backend.dispatch", "shard": shard,
                    "step": k}); ts += 1
        evs.append({"ts": ts, "ev": "backend.decode", "shard": shard,
                    "step": k, "dur_us": 1}); ts += 2
        evs.append({"ts": ts, "ev": "engine.token", "rid": 0}); ts += 1
    evs.append({"ts": ts, "ev": "backend.commit", "shard": shard,
                "step": steps - 1})
    return evs


def _replay(evs, **kw):
    """The port's replay of ``evs`` (JSONL lines), held to the
    reference's report, JSON and all."""
    lines = [json.dumps(e) for e in evs]
    got = traces.analyze_trace(lines, **kw)
    want = jraces.analyze_trace(lines, **kw)
    assert got.to_json() == want.to_json()
    return got


def test_replay_accepts_legal_pipelined_trace():
    report = _replay(_trace(), require_pipeline=True)
    assert report.ok, [v.msg for v in report.violations]
    assert report.stats["lag_tokens"] >= 1
    assert json.loads(report.to_json())["ok"] is True


def test_replay_catches_timestamp_level_commit_before_sync():
    evs = _trace()
    sync1 = next(e for e in evs if e["ev"] == "backend.decode"
                 and e["step"] == 1)
    commit1 = next(e for e in evs if e["ev"] == "backend.commit"
                   and e["step"] == 1)
    commit1["ts"] = sync1["ts"] - 1      # write-back ahead of its logits
    report = _replay(evs, require_pipeline=True)
    assert any(v.code == "commit-before-sync" for v in report.violations)


def test_replay_catches_prefill_inside_undrained_pipeline():
    evs = _trace()
    sync1 = next(e for e in evs if e["ev"] == "backend.decode"
                 and e["step"] == 1)
    evs.append({"ts": sync1["ts"] + 1, "ev": "backend.prefill",
                "shard": 0, "dur_us": 0})
    assert any(v.code == "barrier-missed" for v in _replay(evs).violations)


def test_replay_tolerates_ring_buffer_truncation():
    report = _replay(_trace(steps=4)[4:], require_pipeline=True)
    assert report.ok, [v.msg for v in report.violations]


def test_replay_require_pipeline_distinguishes_off_from_sequential():
    report = _replay([{"ts": 0, "ev": "engine.token", "rid": 0}],
                     require_pipeline=True)
    assert [v.code for v in report.violations] == ["no-pipeline"]
    evs, ts = [], 0
    for k in range(2):
        for ev in ("backend.dispatch", "backend.decode", "backend.commit"):
            evs.append({"ts": ts, "ev": ev, "shard": 0, "step": k})
            ts += 1
        evs.append({"ts": ts, "ev": "engine.token", "rid": 0}); ts += 1
    report = _replay(evs, require_pipeline=True)
    assert [v.code for v in report.violations] == ["no-lag"]


def test_replay_accepts_legal_pause_resume_trace():
    evs = _trace(steps=2)
    ts = evs[-1]["ts"] + 1
    evs += [{"ts": ts, "ev": "backend.pause", "shard": 0, "sid": 3},
            {"ts": ts + 1, "ev": "backend.resume", "shard": 0},
            {"ts": ts + 2, "ev": "backend.dispatch", "shard": 0, "step": 2},
            {"ts": ts + 3, "ev": "backend.decode", "shard": 0, "step": 2,
             "dur_us": 1},
            {"ts": ts + 4, "ev": "engine.token", "rid": 0},
            {"ts": ts + 5, "ev": "backend.commit", "shard": 0, "step": 2}]
    report = _replay(evs, require_pipeline=True)
    assert report.ok, [v.msg for v in report.violations]


def test_replay_catches_pause_before_write_back_commit():
    evs = _trace(steps=3)
    sync1 = next(e for e in evs if e["ev"] == "backend.decode"
                 and e["step"] == 1)
    evs.append({"ts": sync1["ts"] + 1, "ev": "backend.pause", "shard": 0})
    report = _replay(evs)
    msgs = [v.msg for v in report.violations
            if v.code == "preempt-during-dispatch"]
    assert msgs and "flush barrier" in msgs[0]


def test_replay_two_shard_trace(tmp_path):
    evs = _trace(steps=3, shard=0) + _trace(steps=3, shard=1, t0=1000)
    report = _replay(evs, require_pipeline=True)
    assert report.ok and report.stats["shards"] == 2
    path = tmp_path / "trace.jsonl"
    path.write_text("\n".join(json.dumps(e) for e in evs) + "\n\n{bad\n")
    got = traces.analyze_trace_file(str(path), require_pipeline=True)
    assert got.to_json() == jraces.analyze_trace_file(
        str(path), require_pipeline=True).to_json()
    out = tmp_path / "races.json"
    assert traces.main([str(path), "--require-pipeline", "--json",
                        str(out)]) == 0
    assert json.loads(out.read_text()) == got.to_dict()


# ---------------------------------------------------------------------------
# refcount sanitizer
# ---------------------------------------------------------------------------

def _pool(m, n=16, bs=4, **kw):
    return m.BlockPool(m.PoolConfig(num_blocks=n, block_size=bs, **kw))


def _both(fn):
    """Run ``fn(pool module, refsan module)`` on the reference and on the
    port; the sanitizers' findings and counts must agree.  Returns the
    port's sanitizer."""
    jsan = fn(jpool, jrefsan)
    tsan = fn(tpool, trefsan)
    # both packages' pools are driven from the same ``run`` of this file,
    # so even the call sites (file:line:function) agree
    assert tsan.report(quiesced=True) == jsan.report(quiesced=True)
    return tsan


def test_refsan_clean_on_legal_lifecycle():
    def run(m, rs):
        pool = _pool(m)
        san = rs.attach(pool)
        a = pool.alloc(3)
        pool.incref(a[0])
        pool.decref(a[0])
        pool.decref(a[0], cache=True)        # -> cached
        pool.reuse_cached(a[0])              # prefix hit revives it
        for bid in a:
            pool.decref(bid)
        san.check(quiesced=True)
        return san
    san = _both(run)
    san.detach()
    san.pool.check_invariants()


def test_refsan_catches_double_free():
    def run(m, rs):
        pool = _pool(m)
        san = rs.attach(pool)
        (bid,) = pool.alloc(1)
        pool.decref(bid)
        pool._free_block(bid)                # seeded double-free
        return san
    san = _both(run)
    assert "double-free" in [f.kind for f in san.findings]
    san.detach()


def test_refsan_catches_use_after_free_by_id_reuse():
    def run(m, rs):
        pool = _pool(m, n=4)
        san = rs.attach(pool)
        (stale,) = pool.alloc(1)
        pool.decref(stale)                   # freed; holder keeps the id
        (fresh,) = pool.alloc(1)             # id recycled to a new owner
        assert fresh == stale
        pool.decref(fresh)
        pool.touch(stale)                    # stale holder pokes the slot
        return san
    san = _both(run)
    f = next(f for f in san.findings if f.kind == "use-after-free")
    assert "reuse" in f.msg and f.gen == 2
    assert "test_torch_analysis.py" in f.site
    san.detach()


def test_refsan_catches_write_to_freed_block():
    def run(m, rs):
        pool = _pool(m, n=4, bs=2, n_kv_heads=1, head_dim=2, n_layers=1)
        san = rs.attach(pool)
        (bid,) = pool.alloc(1)
        pool.decref(bid)
        kv = np.zeros((1, 2, 1, 2), np.float32)
        pool.write_kv(bid, 0, kv, kv)        # seeded UAF write
        return san
    san = _both(run)
    assert any(f.kind == "use-after-free" and f.op == "write_kv"
               for f in san.findings)
    with pytest.raises(AssertionError, match="freed block"):
        san.check()
    san.detach()


def test_refsan_reports_leaks_with_alloc_provenance():
    def run(m, rs):
        pool = _pool(m)
        san = rs.attach(pool)
        pool.alloc(2)                        # never freed
        return san
    san = _both(run)
    rep = san.report(quiesced=True)
    leaks = [f for f in rep["findings"] if f["kind"] == "leak"]
    assert not rep["ok"] and len(leaks) == 2
    # the call site names this file, not the port's pool or refsan
    assert all("test_torch_analysis.py" in f["history"] for f in leaks)
    san.detach()


def test_refsan_detach_restores_methods():
    def run(m, rs):
        pool = _pool(m)
        san = rs.attach(pool)
        names = [pool.alloc.__name__]
        san.detach()
        names.append(pool.alloc.__name__)
        pool.decref(pool.alloc(1)[0])        # plain pool still works
        return names
    assert run(tpool, trefsan) == run(jpool, jrefsan) == \
        ["refsan_alloc", "alloc"]


def test_refsan_attaches_per_shard_on_sharded_pool():
    def run(m, rs):
        sp = (jsharded if m is jpool else tsharded).ShardedBlockPool(
            m.PoolConfig(num_blocks=16, block_size=4), n_shards=2)
        san = rs.attach(sp)
        a = sp.shards[0].alloc(2)
        sp.shards[1].alloc(1)
        for bid in a:
            sp.shards[0].decref(bid)
        return san
    jsan, tsan = run(jpool, jrefsan), run(tpool, trefsan)
    rep, want = tsan.report(quiesced=True), jsan.report(quiesced=True)
    assert rep["counts"] == want["counts"]
    leaks = [f for f in rep["findings"] if f["kind"] == "leak"]
    assert [(f["bid"], f["gen"]) for f in leaks] == \
        [(f["bid"], f["gen"]) for f in want["findings"]]
    assert len(leaks) == 1               # the shard-1 block
    tsan.detach()
    jsan.detach()
