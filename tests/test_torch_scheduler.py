"""Differential test of the port's ``MarsScheduler``: the same request
stream (hot prefix pages, forked samples, three traffic classes, a pool
that bounds admission) offered and drained through both packages gives
the same admissions, the same batches in the same order, the same
preemption hints and identical stats."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.kvcache import pool as jpool  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.kvcache import pool as tpool  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402


def _stream(n, classes, seed):
    rng = np.random.default_rng(seed)
    hot = [tuple(int(x) for x in rng.integers(1, 500, 16)) for _ in range(5)]
    out = []
    for i in range(n):
        out.append(dict(
            rid=i, prompt=hot[int(rng.integers(5))]
            + tuple(int(x) for x in rng.integers(1, 500, rng.integers(1, 9))),
            arrival=i * 1e-3 * float(rng.integers(1, 4)), prefix_len=16,
            max_new=int(rng.integers(1, 24)),
            n_samples=int(rng.choice([1, 1, 1, 2, 3])),
            traffic_class=classes[i % len(classes)] if classes else "default"))
    return out


def _side(mod, pool_mod, n_classes, mars, request_q):
    pool = pool_mod.BlockPool(pool_mod.PoolConfig(num_blocks=20,
                                                  block_size=16))
    classes = mod.default_classes(n_classes) if n_classes > 1 else None
    return mod.MarsScheduler(request_q=request_q, pool=pool, mars=mars,
                             classes=classes), pool


def _hist(s, c):
    return s.wait_hist[c].to_snapshot()


@pytest.mark.parametrize("n_classes,mars,request_q", [
    (0, True, 512), (3, True, 512), (0, False, 512), (3, True, 2),
])
def test_scheduler_differential(n_classes, mars, request_q):
    js, jp = _side(jsched, jpool, n_classes, mars, request_q)
    ts, tp = _side(tsched, tpool, n_classes, mars, request_q)
    names = [c.name for c in js.classes.values()] if n_classes > 1 else None
    stream = _stream(120, names, seed=n_classes + 10 * mars)
    pending = list(stream)
    held: list = []                  # (release step, blocks) reservations
    for step in range(400):
        now = step * 2e-3
        # offer in arrival order until the first backpressure
        while pending and pending[0]["arrival"] <= now:
            kw = pending[0]
            ok_j = js.offer(jsched.Request(**kw))
            ok_t = ts.offer(tsched.Request(**kw))
            assert ok_t == ok_j, kw["rid"]
            if not ok_j:
                break
            pending.pop(0)
        assert ts.take_preempt_hint() == js.take_preempt_hint()
        cost = (lambda r: r.n_samples)
        bj = js.schedule_batch(4, now=now, cost_fn=cost)
        bt = ts.schedule_batch(4, now=now, cost_fn=cost)
        assert [r.rid for r in bt] == [r.rid for r in bj]
        assert tsched.unique_prefix_blocks(bt) == \
            jsched.unique_prefix_blocks(bj)
        for r in bj:                 # the work finishes a few steps later
            held.append((step + 3 + r.rid % 4, r.blocks_needed(16)))
        for item in [h for h in held if h[0] == step]:
            held.remove(item)
            jp.unreserve(item[1])
            tp.unreserve(item[1])
        assert len(ts) == len(js)
        assert tp.reserved == jp.reserved
        assert ts.stats.as_dict() == js.stats.as_dict()
        for c in js.class_stats:
            assert ts.class_stats[c].as_dict() == js.class_stats[c].as_dict()
            assert _hist(ts, c) == _hist(js, c)
        if not pending and not len(js) and not held:
            break
    assert not pending and not len(ts)
    assert ts.stats.scheduled == len(stream)
    assert ts.stats.pages_per_batch == js.stats.pages_per_batch
    assert ts.stats.mean_wait == js.stats.mean_wait
    if request_q < 512:
        assert ts.stats.stall_rejects > 0
    else:
        assert ts.stats.pool_rejects > 0


def test_request_pages_and_block_needs_match():
    for kw in _stream(40, None, seed=3):
        jr, tr = jsched.Request(**kw), tsched.Request(**kw)
        assert tr.page == jr.page
        for bs in (4, 16):
            assert tr.blocks_needed(bs) == jr.blocks_needed(bs)
    assert [(c.name, c.latency, c.quota, c.queue_depth, c.max_age)
            for c in tsched.default_classes(3)] == \
        [(c.name, c.latency, c.quota, c.queue_depth, c.max_age)
         for c in jsched.default_classes(3)]
