"""The paper simulator's two CUDA kernels against their plain twins, on
the card (marked ``cuda``; they skip without one).  ``chip_smoke.py``'s
sim phase holds both at the paper's size; these add the shapes it does
not reach: S2 at windows of 2 to 4 slots a lane (100) and 8 (256, the
largest), with writes and banks fewer than the lanes, and S1 with a
single port, one way, a RequestQ smaller than a warp's free words and
an MSHR cap of 1, and both batched: S1 streams under mixed
configurations (up to 8 and up to 32 ports, 1 to 8 ways) in one launch,
S2 several streams in one.

Run them with ``PYTHONPATH=src python -m pytest -q -m cuda tests`` on a
machine with an H100; this file imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dram, mars, streams  # noqa: E402
from repro_torch.kernels.dram_channel import dram_channel as dc  # noqa: E402
from repro_torch.kernels.mars_engine import mars_engine as me  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    mars.MarsConfig(n_ports=1),
    mars.MarsConfig(ways=1, page_entries=16),
    mars.MarsConfig(request_q=40, page_entries=12, ways=3, mshr_per_core=1),
    mars.MarsConfig(request_q=1024, page_entries=256, ways=4, n_ports=2,
                    mshr_per_core=64)], ids=["ports1", "ways1", "q40",
                                             "q1024"])
def test_mars_engine_kernel_equals_twin(cfg):
    _card()
    gpu = streams.GpuConfig(n_cores=16, cores_per_group=8)
    s = streams.make_workload("WL2", gpu, reqs_per_core=64)
    src = np.asarray(s.source)
    launches = me.mars_engine.launches
    perm, stats = mars.mars_reorder(s.addr, src // 8, cfg, src=src,
                                    device="cuda")
    assert me.mars_engine.launches == launches + 1
    want, want_stats = mars.mars_reorder(s.addr, src // 8, cfg, src=src,
                                         device="cpu")
    np.testing.assert_array_equal(perm, want)
    assert stats == want_stats
    np.testing.assert_array_equal(perm, mars.mars_reorder_reference(
        s.addr, src // 8, cfg, src))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 8, 33, 100, 256])
@pytest.mark.parametrize("banks", [8, 3])
def test_dram_channel_kernel_equals_twin(window, banks):
    _card()
    rng = np.random.default_rng(window)
    pages = rng.integers(0, 400, 700)
    addr = (pages[:, None] * 64 + np.arange(6)).reshape(-1)
    wr = rng.random(len(addr)) < 0.25
    cfg = dram.DramConfig(window=window, n_banks=banks)
    ops = [torch.from_numpy(a) for a in dram.channel_operands(addr, cfg,
                                                              wr)]
    launches = dc.dram_channels.launches
    got = dc.dram_channels(*(t.cuda() for t in ops), cfg).cpu()
    assert dc.dram_channels.launches == launches + 1
    assert got.tolist() == dc.dram_channels(*ops, cfg).tolist()
    short = [t.clone() for t in ops]
    short[2] = torch.tensor([0, min(window // 2, 5), min(window // 2, 5)],
                            dtype=torch.int64)
    got = dc.dram_channels(*(t.cuda() for t in short), cfg).cpu()
    assert got.tolist() == dc.dram_channels(*short, cfg).tolist()


BATCH_CONFIGS = [mars.MarsConfig(), mars.MarsConfig(n_ports=1),
                 mars.MarsConfig(n_ports=2, ways=4, page_entries=32),
                 mars.MarsConfig(request_q=40, page_entries=12, ways=3,
                                 mshr_per_core=1),
                 mars.MarsConfig(ways=8, page_entries=64),
                 mars.MarsConfig(n_ports=32, request_q=64, mshr_per_core=2)]


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["ports8", "ports32"])
def test_mars_engine_batch_equals_twin_per_instance(wide):
    """One launch for streams under mixed configurations (one port to
    eight, or up to 32: the kernel's two port bounds; 1 to 8 ways, a
    RequestQ that fills), each equal to the twin and the oracle."""
    _card()
    cfgs = [c for c in BATCH_CONFIGS if (c.n_ports > 8) == wide or
            c.n_ports == 1]
    items = []
    for i, cfg in enumerate(cfgs):
        gpu = streams.GpuConfig(n_cores=16, cores_per_group=8)
        s = streams.make_workload(streams.WORKLOADS[i % 5], gpu,
                                  reqs_per_core=48, seed=i)
        src = np.asarray(s.source)
        items.append((s.addr, src % cfg.n_ports, cfg, src))
    items.append((np.zeros(0, np.int32), None, cfgs[0], None))
    launches = me.mars_engine.launches
    got = mars.mars_reorder_many(items, device="cuda")
    assert me.mars_engine.launches == launches + 1
    want = mars.mars_reorder_many(items, device="cpu")
    for (addr, ports, cfg, src), (p, st), (wp, wst) in zip(items, got, want):
        np.testing.assert_array_equal(p, wp)
        assert st == wst
        if len(addr):
            np.testing.assert_array_equal(p, mars.mars_reorder_reference(
                addr, ports, cfg, src))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [8, 64, 256])
def test_simulate_many_equals_twin(window):
    """Several streams, an empty one and one shorter than the window
    among them, in one launch: each ``DramResult`` equals the twin's."""
    _card()
    rng = np.random.default_rng(window)
    pages = rng.integers(0, 300, 500)
    addr = (pages[:, None] * 64 + np.arange(4)).reshape(-1)
    ss = [(addr, rng.random(len(addr)) < 0.3), (addr[::-1].copy(), None),
          (np.zeros(0, np.int32), None), (addr[:5], None)]
    cfg = dram.DramConfig(window=window)
    launches = dc.dram_channels.launches
    got = dram.simulate_many(ss, cfg, device="cuda")
    assert dc.dram_channels.launches == launches + 1
    assert got == dram.simulate_many(ss, cfg, device="cpu")
