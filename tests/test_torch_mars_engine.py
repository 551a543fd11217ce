"""The port's MARS cycle engine (``repro_torch.core.mars``) on the CPU.

The counterparts of ``tests/test_mars_engine.py`` run on the port alone
(``device="cpu"``: the kernel's plain twin): the engine equals the
OrderedDict oracle, drains into a permutation that groups pages, keeps
FIFO order within a page and port, passes single pages through unchanged,
spreads strided pages over the sets and respects the MSHR cap.  Then the
plain twin is held to the reference's ``jax.lax.scan`` (``mars._run``)
cycle by cycle: the same emitted index (or -1) at every cycle and the same
stall count, across configurations.  Then the CUDA route: it refuses
operands the kernel does not take and never falls back to the twin, one
stream or many.  Last, the batched engine (``mars_reorder_many``) against
a loop and the JAX package, and a model of the kernel's free-slot stack
against the twin and the oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # property tests skip below; the rest collects
    given = settings = st = None

import jax.numpy as jnp  # noqa: E402

from repro.core import mars as jmars  # noqa: E402
from repro_torch.core import mars, streams  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mars_engine import mars_engine as me  # noqa: E402
from repro_torch.kernels.mars_engine.ref import mars_engine_plain  # noqa: E402

torch.set_num_threads(1)


def _runs(x):
    x = np.asarray(x)
    if len(x) == 0:
        return np.array([0])
    return np.diff(np.flatnonzero(np.concatenate(
        [[True], x[1:] != x[:-1], [True]])))


def _reorder(addr, ports=None, cfg=None, src=None):
    return mars.mars_reorder(addr, ports, cfg, src=src, device="cpu")


@pytest.mark.parametrize("wl", streams.WORKLOADS)
def test_engine_matches_oracle(wl):
    gpu = streams.GpuConfig(n_cores=16, cores_per_group=8)
    s = streams.make_workload(wl, gpu, reqs_per_core=64)
    ports = np.asarray(s.source) // gpu.cores_per_group
    perm, _ = _reorder(s.addr, ports, src=np.asarray(s.source))
    ref = mars.mars_reorder_reference(s.addr, ports, src=np.asarray(s.source))
    np.testing.assert_array_equal(perm, ref)


def test_permutation_and_grouping():
    s = streams.make_workload("WL1", reqs_per_core=64)
    ports = np.asarray(s.source) // 8
    perm, stats = _reorder(s.addr, ports, src=np.asarray(s.source))
    n = s.n
    assert sorted(perm) == list(range(n))
    pages = np.asarray(s.addr) >> streams.PAGE_SHIFT
    # MARS must not reduce page-run length on average
    assert _runs(pages[perm]).mean() >= _runs(pages).mean()
    assert stats["total_cycles"] >= n


def test_fifo_within_page():
    """Requests of one page must leave MARS in arrival order."""
    s = streams.make_workload("WL2", reqs_per_core=64)
    ports = np.asarray(s.source) // 8
    perm, _ = _reorder(s.addr, ports, src=np.asarray(s.source))
    pages = np.asarray(s.addr) >> streams.PAGE_SHIFT
    pos = np.argsort(perm)  # original idx -> output position
    port_of = np.asarray(ports)
    for pg in np.unique(pages)[:50]:
        for p in np.unique(port_of):
            idx = np.flatnonzero((pages == pg) & (port_of == p))
            # same page, same port => FIFO preserved
            assert np.all(np.diff(pos[idx]) > 0)


if st is not None:
    @settings(max_examples=20, deadline=None)
    @given(st.lists(st.integers(0, 40), min_size=1, max_size=300),
           st.integers(1, 4), st.sampled_from([8, 16, 32]))
    def test_random_streams_always_drain(page_list, ways, page_entries):
        """Property: any input drains completely into a valid permutation,
        the oracle's, over ways and PhyPageList sizes."""
        pages = np.asarray(page_list, np.int32)
        addr = pages << streams.PAGE_SHIFT
        cfg = mars.MarsConfig(request_q=64, page_entries=page_entries,
                              ways=ways, n_ports=2, mshr_per_core=8)
        perm, _ = _reorder(addr, cfg=cfg)
        assert sorted(perm) == list(range(len(addr)))
        ref = mars.mars_reorder_reference(addr, cfg=cfg)
        np.testing.assert_array_equal(perm, ref)
else:
    def test_random_streams_always_drain():
        pytest.importorskip("hypothesis")


def test_single_page_stream_is_identity():
    addr = np.arange(50, dtype=np.int32)  # all within page 0
    perm, _ = _reorder(addr, ports=np.zeros(50, np.int64))
    np.testing.assert_array_equal(perm, np.arange(50))


def test_page_set_hash_spreads_strides():
    for stride in (1, 2, 8, 64, 128, 4096):
        pages = np.arange(0, 64 * stride, stride)
        sets = np.array([mars._page_set_py(int(p), 64) for p in pages])
        # a decent hash puts 64 strided pages into >= 24 distinct sets
        assert len(np.unique(sets)) >= 24, (stride, len(np.unique(sets)))


def test_mshr_cap_bounds_inflight():
    """No core may ever exceed its MSHR allowance inside the queue."""
    gpu = streams.GpuConfig(n_cores=16, cores_per_group=8)
    s = streams.make_workload("WL1", gpu, reqs_per_core=64)
    cfg = mars.MarsConfig(mshr_per_core=4)
    ports = np.asarray(s.source) // gpu.cores_per_group
    perm, _ = _reorder(s.addr, ports, cfg, src=np.asarray(s.source))
    pos = np.argsort(perm)
    src = np.asarray(s.source)
    for c in np.unique(src)[:8]:
        emits = np.sort(pos[src == c])
        gaps = emits[cfg.mshr_per_core:] - emits[:-cfg.mshr_per_core]
        assert np.all(gaps > 0)


def test_stats_of_the_paper_workload():
    """WL1 at 256 requests a core (n = 16384): the reference's stall count
    and last-forward cycle (the JAX package's ``mars_reorder``)."""
    s = streams.make_workload("WL1", reqs_per_core=256)
    ports = np.asarray(s.source) // 8
    _, stats = _reorder(s.addr, ports, src=np.asarray(s.source))
    assert stats["stall_events"] == 42326
    assert stats["total_cycles"] == 16384
    assert stats["idle_frac"] == 0.0


def test_empty_stream():
    perm, stats = _reorder(np.zeros(0, np.int32))
    assert perm.shape == (0,) and perm.dtype == np.int64
    assert stats == {"stall_events": 0, "total_cycles": 0, "idle_frac": 0.0}


# ---------------------------------------------------------------------------
# the plain twin against the reference's scan, cycle by cycle
# ---------------------------------------------------------------------------

TWIN_CONFIGS = [
    jmars.MarsConfig(),
    jmars.MarsConfig(request_q=64, page_entries=16, ways=1, n_ports=2,
                     mshr_per_core=4),
    jmars.MarsConfig(request_q=96, page_entries=24, ways=3, n_ports=4,
                     mshr_per_core=64),
    jmars.MarsConfig(request_q=128, page_entries=8, ways=4, n_ports=1,
                     mshr_per_core=16),
]


def _twin_vs_scan(addr, ports, src, jcfg):
    cfg = mars.MarsConfig(**jcfg.__dict__)
    pages, port_req, port_len, src_, n_cores = mars.prepare(addr, ports, cfg,
                                                            src)
    state, emits = jmars._run(jnp.asarray(pages), jnp.asarray(port_req),
                              jnp.asarray(port_len), jnp.asarray(src_),
                              len(addr), n_cores, jcfg)
    got, stalls = mars_engine_plain(pages, port_req, port_len, src_,
                                    len(addr), n_cores, cfg)
    np.testing.assert_array_equal(got, np.asarray(emits))
    assert stalls == int(state.stalls)
    return got


@pytest.mark.parametrize("ci", range(len(TWIN_CONFIGS)))
@pytest.mark.parametrize("wl", ["WL1", "WL2", "WL5"])
def test_twin_emits_every_cycle_as_the_scan(wl, ci):
    gpu = streams.GpuConfig(n_cores=16, cores_per_group=8)
    s = streams.make_workload(wl, gpu, reqs_per_core=24)
    src = np.asarray(s.source)
    emits = _twin_vs_scan(s.addr, src // 8, src, TWIN_CONFIGS[ci])
    assert (emits >= 0).sum() == s.n


@pytest.mark.parametrize("kind", ["one_page", "plen_zero", "mshr_bound"])
def test_twin_edges_as_the_scan(kind):
    """A single page, ports with no requests (their reads clamp to
    ``port_req[p, 0] == -1``), and cores held at their MSHR cap (no input,
    so no stall)."""
    rng = np.random.default_rng(7)
    if kind == "one_page":
        addr = rng.integers(0, 64, 200).astype(np.int32)
        ports, src = np.arange(200) % 8, None
    elif kind == "plen_zero":
        addr = (rng.integers(0, 12, 150) * 64).astype(np.int32)
        ports, src = np.where(rng.random(150) < 0.5, 1, 5), None
    else:
        addr = (rng.integers(0, 30, 300) * 64).astype(np.int32)
        src = rng.integers(0, 3, 300).astype(np.int32)
        ports = src % 2
    _twin_vs_scan(addr, ports, src, TWIN_CONFIGS[1] if kind == "mshr_bound"
                  else TWIN_CONFIGS[0])


# ---------------------------------------------------------------------------
# the CUDA route
# ---------------------------------------------------------------------------

def test_reorder_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        mars.mars_reorder(np.arange(64, dtype=np.int32))


def _one_or_many(batched: bool):
    """``mars_engine`` or its batched form (one instance beside a valid
    one), as a function of mars_engine's arguments."""
    if not batched:
        return me.mars_engine
    cfg = mars.MarsConfig()
    ok = [torch.from_numpy(a) for a in mars.prepare(
        np.arange(32, dtype=np.int32) * 64, cfg=cfg)[:4]]
    return lambda *a: me.mars_engine_many([(*ok, 8, cfg), a])


@pytest.mark.parametrize("batched", [False, True], ids=["one", "many"])
def test_wrapper_refuses_what_the_kernel_does_not_take(batched):
    run = _one_or_many(batched)
    cfg = mars.MarsConfig()
    pages, port_req, port_len, src, _ = mars.prepare(
        np.arange(64, dtype=np.int32) * 64, cfg=cfg)
    t = [torch.from_numpy(a) for a in (pages, port_req, port_len, src)]
    with pytest.raises(TypeError, match="int32"):
        run(t[0].long(), *t[1:], 8, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        run(t[0], t[1].t(), *t[2:], 8, cfg)
    with pytest.raises(ValueError, match="n_ports"):
        run(*t, 8, mars.MarsConfig(n_ports=4))
    with pytest.raises(ValueError, match="RequestQ"):
        run(*t, 8, mars.MarsConfig(request_q=2048))
    wide = mars.MarsConfig(n_ports=64)     # the port mask is one word
    w = [torch.from_numpy(a) for a in mars.prepare(
        np.arange(64, dtype=np.int32) * 64, cfg=wide)[:4]]
    with pytest.raises(ValueError, match="n_ports"):
        run(*w, 8, wide)
    with pytest.raises(ValueError, match="ways"):   # valid ways: one word
        run(*t, 8, mars.MarsConfig(ways=64, page_entries=128))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "many"])
def test_wrapper_never_falls_back(batched):
    """A CUDA-bound launch goes to the build (which needs nvcc): it never
    computes the plain twin instead."""
    cfg = mars.MarsConfig()
    pages, port_req, port_len, src, n_cores = mars.prepare(
        np.arange(64, dtype=np.int32) * 64, cfg=cfg)
    t = [torch.from_numpy(a) for a in (pages, port_req, port_len, src)]
    launches = me.mars_engine.launches
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            if batched:
                me._launch_many([(*t, n_cores, cfg)] * 3)
            else:
                me._launch(*t, n_cores, cfg)
    assert me.mars_engine.launches == launches


def test_cpu_wrapper_compacts_the_twin():
    """On CPU tensors the wrapper returns the twin's forwards in order,
    their count, the stalls and the last forward's cycle + 1."""
    gpu = streams.GpuConfig(n_cores=16, cores_per_group=8)
    s = streams.make_workload("WL4", gpu, reqs_per_core=16)
    src = np.asarray(s.source)
    cfg = mars.MarsConfig()
    pages, port_req, port_len, src_, n_cores = mars.prepare(
        s.addr, src // 8, cfg, src)
    emits, stalls = mars_engine_plain(pages, port_req, port_len, src_, s.n,
                                      n_cores, cfg)
    perm, stats = me.mars_engine(
        *(torch.from_numpy(a) for a in (pages, port_req, port_len, src_)),
        n_cores, cfg)
    cycles = np.flatnonzero(emits >= 0)
    np.testing.assert_array_equal(perm.numpy(), emits[cycles])
    assert stats.tolist() == [s.n, stalls, int(cycles[-1]) + 1]


# ---------------------------------------------------------------------------
# the batched engine
# ---------------------------------------------------------------------------

BATCH_CONFIGS = [jmars.MarsConfig(),
                 jmars.MarsConfig(n_ports=1, ways=1, page_entries=16),
                 jmars.MarsConfig(n_ports=2, ways=4, page_entries=64,
                                  request_q=8, mshr_per_core=64)]


def test_mars_reorder_many_equals_a_loop_and_the_jax_package():
    """WL1-WL5 at RPC 16 under three configurations in one batch (1, 2 and
    8 ports; 1, 2 and 4 ways; a RequestQ of 8 that fills): each equals
    ``mars_reorder`` alone and the JAX package's ``mars_reorder``."""
    items = []
    for jcfg in BATCH_CONFIGS:
        for wl in streams.WORKLOADS:
            s = streams.make_workload(wl, reqs_per_core=16)
            src = np.asarray(s.source)
            items.append((np.asarray(s.addr), src // 8,
                          mars.MarsConfig(**jcfg.__dict__), src, jcfg))
    got = mars.mars_reorder_many([it[:4] for it in items], device="cpu")
    assert len(got) == len(items)
    for (addr, ports, cfg, src, jcfg), (perm, stats) in zip(items, got):
        alone = mars.mars_reorder(addr, ports, cfg, src=src, device="cpu")
        np.testing.assert_array_equal(perm, alone[0])
        assert stats == alone[1]
        want, wstats = jmars.mars_reorder(addr, ports, jcfg, src=src)
        np.testing.assert_array_equal(perm, np.asarray(want))
        assert stats == wstats
    # the RequestQ of 8 (two ports, one forward a cycle) stalls its ports
    assert got[-1][1]["stall_events"] > 0


def test_mars_reorder_many_empty_and_none():
    out = mars.mars_reorder_many(
        [(np.zeros(0, np.int32), None, None, None),
         (np.arange(40, dtype=np.int32), None, None, None)], device="cpu")
    assert out[0][0].shape == (0,) and out[0][1]["total_cycles"] == 0
    np.testing.assert_array_equal(out[1][0], np.arange(40))
    assert mars.mars_reorder_many([], device="cpu") == []


def _lifo_engine(pages, port_req, port_len, src, n_req, n_cores, cfg):
    """The CUDA kernel's RequestQ on the host: the twin's cycle loop, with
    the free slots a stack (pop on insert, push on forward) in place of
    the lowest free slot.  Returns (emits, stalls) as the twin does."""
    Q, S, W, P = cfg.request_q, cfg.nsets, cfg.ways, cfg.order_q
    pages, src = [int(v) for v in pages], [int(v) for v in src]
    port_req = [[int(v) for v in row] for row in port_req]
    port_len = [int(v) for v in port_len]
    emits = np.full(mars.n_cycles(n_req, cfg), -1, np.int32)
    free = list(range(Q - 1, -1, -1))       # the top is the list's end
    rq_order, rq_next = [0] * Q, [-1] * Q
    ppl = {}                                # (set, way) -> [page, head, tail]
    poq, cursors, inflight = [], [0] * cfg.n_ports, [0] * max(n_cores, 1)
    stalls = inserted = 0
    for cycle in range(len(emits)):
        if inserted == sum(port_len) and not poq:
            break
        for p in range(cfg.n_ports):
            cur = cursors[p]
            if cur >= port_len[p]:
                continue
            g = port_req[p][cur]
            core = max(src[g], 0)
            if inflight[core] >= cfg.mshr_per_core:
                continue
            s = mars._page_set_py(pages[g], S)
            ways = [w for w in range(W) if (s, w) in ppl]
            hit = [w for w in ways if ppl[s, w][0] == pages[g]]
            free_way = [w for w in range(W) if (s, w) not in ppl]
            if not free or not (hit or free_way):
                stalls += 1
                continue
            slot = free.pop()
            rq_order[slot], rq_next[slot] = g, -1
            if hit:
                rq_next[ppl[s, hit[0]][2]] = slot
                ppl[s, hit[0]][2] = slot
            else:
                ppl[s, free_way[0]] = [pages[g], slot, slot]
                poq.append((s, free_way[0]))
            cursors[p] += 1
            inflight[core] += 1
            inserted += 1
        if poq:
            entry = ppl[poq[0]]
            head = entry[1]
            emits[cycle] = rq_order[head]
            free.append(head)
            if rq_next[head] < 0:
                del ppl[poq.pop(0)]
            else:
                entry[1] = rq_next[head]
            inflight[max(src[rq_order[head]], 0)] -= 1
    return emits, stalls


if st is not None:
    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.integers(0, 30), min_size=1, max_size=250),
           st.integers(1, 4), st.sampled_from([4, 8, 16]),
           st.sampled_from([2, 6, 12]), st.integers(1, 3))
    def test_free_slot_order_is_unobservable(page_list, ways, page_entries,
                                            request_q, n_ports):
        """Property: the kernel's free-slot stack gives the twin's emits
        every cycle and its stalls, and the oracle's permutation, on
        streams that fill the RequestQ and the sets."""
        page_entries = max(page_entries, ways)
        cfg = mars.MarsConfig(request_q=request_q, page_entries=page_entries,
                              ways=ways, n_ports=n_ports, mshr_per_core=64)
        addr = np.asarray(page_list, np.int32) << streams.PAGE_SHIFT
        ops = mars.prepare(addr, None, cfg)
        got = _lifo_engine(*ops[:4], len(addr), ops[4], cfg)
        want = mars_engine_plain(*ops[:4], len(addr), ops[4], cfg)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(
            got[0][got[0] >= 0], mars.mars_reorder_reference(addr, cfg=cfg))
else:
    def test_free_slot_order_is_unobservable():
        pytest.importorskip("hypothesis")
