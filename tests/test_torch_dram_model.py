"""The port's DRAM timing model (``repro_torch.core.dram``) on the CPU.

The counterparts of ``tests/test_dram_model.py``'s analytical anchors run
on the port alone (``device="cpu"``: the kernel's plain twin).  Then the
twin is held to the reference's ``jax.lax.scan`` (``dram._run_channel``):
the same (t_end, n_act, hits) at windows 8, 32 and 64, on streams shorter
than the window, with writes mixed in; and ``simulate`` to the
reference's ``simulate`` field for field.  Then the CUDA route: it
refuses operands the kernel does not take and never falls back to the
twin, for one stream's layout or several.  Last, ``simulate_many``
against a loop of ``simulate`` and the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import dram as jdram  # noqa: E402
from repro.core import mars as jmars  # noqa: E402
from repro.core import streams as jstreams  # noqa: E402
from repro_torch.core import dram  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.dram_channel import dram_channel as dc  # noqa: E402
from repro_torch.kernels.dram_channel.ref import run_channel_plain  # noqa: E402

torch.set_num_threads(1)


def _sim(a, cfg=None, is_write=None):
    return dram.simulate(a, cfg, is_write, device="cpu")


def test_sequential_stream_saturates_bus():
    a = np.arange(16384, dtype=np.int32)
    r = _sim(a)
    assert r.bus_utilization > 0.95
    assert r.cas_per_act > 16  # full rows reused


def test_random_stream_is_activate_bound():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 24, 16384).astype(np.int32)
    r = _sim(a)
    assert r.cas_per_act < 1.3
    # tFAW-limited ceiling: 4 ACT/40clk * 4clk data = 0.4 of peak
    assert r.bus_utilization < 0.45


@pytest.mark.parametrize("runlen", [4, 16, 64])
def test_run_length_monotonicity(runlen):
    rng = np.random.default_rng(1)
    pages = rng.integers(0, 1 << 18, 8192 // runlen).astype(np.int64)
    a = (pages[:, None] * 64 + np.arange(runlen)).reshape(-1).astype(np.int32)
    r = _sim(a)
    # per-channel CA is about half the run length (channel interleave)
    assert r.cas_per_act == pytest.approx(runlen / 2, rel=0.3)


def test_longer_runs_never_slower():
    rng = np.random.default_rng(2)
    utils = []
    for runlen in (2, 8, 32):
        pages = rng.integers(0, 1 << 18, 8192 // runlen).astype(np.int64)
        a = (pages[:, None] * 64 + np.arange(runlen)).reshape(-1)
        utils.append(_sim(a.astype(np.int32)).bus_utilization)
    assert utils[0] <= utils[1] <= utils[2] + 0.02


def test_write_read_turnaround_costs():
    a = np.arange(8192, dtype=np.int32)
    pure = _sim(a, is_write=np.zeros(8192, bool))
    alternating = _sim(a, is_write=(np.arange(8192) % 2 == 0))
    assert alternating.achieved_gbps < pure.achieved_gbps * 0.55


def test_channel_split_is_conserving():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 20, 4096).astype(np.int32)
    cfg = dram.DramConfig()
    ch, local = dram.split_channels(a, cfg)
    assert len(ch) == len(a)
    assert set(np.unique(ch)) <= {0, 1}
    # map is injective: (channel, local) identifies the line
    key = ch.astype(np.int64) << 40 | local
    assert len(np.unique(key)) == len(np.unique(a))


def test_bank_hash_spreads_power_of_two_strides():
    cfg = dram.DramConfig()
    for stride in (8, 64, 512):
        local = np.arange(64) * 32 * stride
        _, bank, _ = dram._decode(local, cfg)
        assert len(np.unique(np.asarray(bank))) >= 6, stride


# ---------------------------------------------------------------------------
# the plain twin against the reference's scan
# ---------------------------------------------------------------------------

def _channel_streams():
    """Channel-0 line ids and write flags of a baseline workload stream and
    a random stream with writes."""
    gpu = jstreams.GpuConfig(n_cores=16, cores_per_group=8)
    s = jstreams.make_workload("WL2", gpu, reqs_per_core=64)
    rng = np.random.default_rng(4)
    r = rng.integers(0, 1 << 16, 1500)
    out = {}
    for name, a, w in (("wl2", np.asarray(s.addr), np.asarray(s.is_write)),
                       ("random", r, rng.random(1500) < 0.4)):
        ch, local = jdram.split_channels(a, jdram.DramConfig())
        out[name] = (local[ch == 0].astype(np.int32), w[ch == 0])
    return out


STREAMS = _channel_streams()


@pytest.mark.parametrize("n", [None, 1, 7, 31, 63])
@pytest.mark.parametrize("window", [8, 32, 64])
@pytest.mark.parametrize("stream", ["wl2", "random"])
def test_twin_equals_run_channel(stream, window, n):
    """(t_end, n_act, hits) of the whole channel stream and of its first
    n requests (below the window: zero padding, only n slots valid)."""
    local, wr = STREAMS[stream]
    if n is not None:
        local, wr = local[:n], wr[:n]
    m = len(local)
    want = jdram._run_channel(jnp.asarray(local), jnp.asarray(wr), m,
                              jdram.DramConfig(window=window))
    got = run_channel_plain(local, wr, dram.DramConfig(window=window))
    assert got == tuple(int(v) for v in want)


@pytest.mark.parametrize("kind", ["workload", "writes", "one_channel",
                                  "empty"])
def test_simulate_equals_reference(kind):
    gpu = jstreams.GpuConfig(n_cores=16, cores_per_group=8)
    s = jstreams.make_workload("WL5", gpu, reqs_per_core=32)
    a, w = np.asarray(s.addr), None
    if kind == "writes":
        w = np.arange(len(a)) % 3 == 0
    elif kind == "one_channel":
        a = (np.arange(300, dtype=np.int32) // 2) * 4
    elif kind == "empty":
        a = np.zeros(0, np.int32)
    want = jdram.simulate(a, is_write=w)
    got = dram.simulate(a, is_write=w, device="cpu")
    assert dataclasses_equal(got, want)


def dataclasses_equal(got, want) -> bool:
    return all(getattr(got, f) == getattr(want, f)
               for f in ("cycles", "n_requests", "n_act", "achieved_gbps",
                         "bus_utilization", "cas_per_act",
                         "per_channel_cycles"))


# ---------------------------------------------------------------------------
# the CUDA route
# ---------------------------------------------------------------------------

def _operands(n=40):
    local = torch.arange(n, dtype=torch.int32)
    wr = torch.zeros(n, dtype=torch.uint8)
    off = torch.tensor([0, n // 2, n], dtype=torch.int64)
    return local, wr, off


def test_simulate_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        dram.simulate(np.arange(64, dtype=np.int32))


def _many_operands():
    """Three streams' operands laid back to back as ``simulate_many``
    lays them (one of them empty)."""
    local, wr, off = _operands()
    n = local.numel()
    return (torch.cat([local, local]), torch.cat([wr, wr]),
            torch.cat([off[:-1], off[:-1] + n, torch.tensor([2 * n] * 3)]))


@pytest.mark.parametrize("layout", ["one", "many"])
def test_wrapper_refuses_what_the_kernel_does_not_take(layout):
    local, wr, off = _operands() if layout == "one" else _many_operands()
    cfg = dram.DramConfig()
    with pytest.raises(TypeError, match="int32"):
        dc.dram_channels(local.long(), wr, off, cfg)
    with pytest.raises(TypeError, match="uint8"):
        dc.dram_channels(local, wr.bool(), off, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        dc.dram_channels(torch.zeros(2 * local.numel(),
                                     dtype=torch.int32)[::2], wr, off, cfg)
    with pytest.raises(ValueError, match="window"):
        dc.dram_channels(local, wr, off, dram.DramConfig(window=300))
    with pytest.raises(ValueError, match="banks"):
        dc.dram_channels(local, wr, off, dram.DramConfig(n_banks=64))


@pytest.mark.parametrize("layout", ["one", "many"])
def test_wrapper_never_falls_back(layout):
    local, wr, off = _operands() if layout == "one" else _many_operands()
    launches = dc.dram_channels.launches
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            dc._launch(local, wr, off, dram.DramConfig())
    assert dc.dram_channels.launches == launches


def test_cpu_wrapper_runs_each_channel_through_the_twin():
    local, wr, off = _operands(90)
    cfg = dram.DramConfig(window=8)
    got = dc.dram_channels(local, wr, off, cfg).tolist()
    want = [list(run_channel_plain(local[a:b].tolist(), wr[a:b].tolist(),
                                   cfg))
            for a, b in ((0, 45), (45, 90))]
    assert got == want


# ---------------------------------------------------------------------------
# several streams in one call
# ---------------------------------------------------------------------------

def _many_streams():
    """(addr, is_write) of WL2's and WL5's baseline and MARS-ordered
    streams (the JAX package's streams and reorder), a stream shorter
    than every window and an empty one."""
    out = []
    for wl in ("WL2", "WL5"):
        gpu = jstreams.GpuConfig(n_cores=16, cores_per_group=8)
        s = jstreams.make_workload(wl, gpu, reqs_per_core=16)
        a, w, src = (np.asarray(x) for x in (s.addr, s.is_write, s.source))
        perm, _ = jmars.mars_reorder(a, src // 8, src=src)
        perm = np.asarray(perm)
        out += [(a, w), (a[perm], w[perm])]
    return out + [(np.arange(5, dtype=np.int32) * 7, None),
                  (np.zeros(0, np.int32), None)]


@pytest.mark.parametrize("window", [8, 32, 64])
def test_simulate_many_equals_a_loop_and_the_jax_package(window):
    ss = _many_streams()
    cfg = dram.DramConfig(window=window)
    got = dram.simulate_many(ss, cfg, device="cpu")
    assert len(got) == len(ss)
    for (a, w), r in zip(ss, got):
        assert r == dram.simulate(a, cfg, w, device="cpu")
        assert dataclasses_equal(r, jdram.simulate(
            a, jdram.DramConfig(window=window), is_write=w))
    assert dram.simulate_many([], cfg, device="cpu") == []
