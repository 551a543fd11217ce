"""End-to-end reproduction checks of the paper's headline claims on the
port (``repro_torch.core.experiment``, ``device="cpu"``: the MARS engine's
and DRAM channels' plain twins).

The counterparts of ``tests/test_repro_paper.py`` run on the port alone at
its RPC 128: positive bandwidth uplift on every workload, mean bandwidth
uplift in [8%, 60%], mean CAS/ACT uplift in [50%, 200%], >2x CAS/ACT on
WL1/WL5, and the locality of Figure 2.  The port's numbers are then held
to the reference's integers: at RPC 128 to the JAX package's cycles, ACTs
and means (measured once with the JAX package on the CPU and written
here), and at RPC 64 to the JAX ``run_all`` itself, field for field.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import experiment as jexperiment  # noqa: E402
from repro_torch.benchmarks import ablations, paper_figures  # noqa: E402
from repro_torch.core import experiment, streams  # noqa: E402

torch.set_num_threads(1)

RPC = 128  # keep CI fast; benchmarks use 256
# the JAX package's run_all(reqs_per_core=128): (baseline cycles,
# baseline ACTs, MARS cycles, MARS ACTs) a workload and the two means
REFERENCE_128 = {"WL1": (21667, 2430, 19093, 1066),
                 "WL2": (33287, 3546, 26731, 2324),
                 "WL3": (21667, 2430, 19093, 1066),
                 "WL4": (25773, 3546, 20023, 1877),
                 "WL5": (32481, 3062, 25771, 1455)}
REFERENCE_128_MEANS = (0.21248517297044991, 1.0157138433021415)


@pytest.fixture(scope="module")
def results():
    return experiment.run_all(reqs_per_core=RPC, device="cpu")


def test_bw_uplift_every_workload(results):
    for r in results:
        assert r.bw_uplift > 0.0, (r.name, r.bw_uplift)


def test_mean_bw_uplift_magnitude(results):
    s = experiment.summarize(results)
    assert 0.08 <= s["mean_bw_uplift"] <= 0.60, s["mean_bw_uplift"]


def test_mean_cas_act_uplift_magnitude(results):
    s = experiment.summarize(results)
    assert 0.50 <= s["mean_cas_act_uplift"] <= 2.00, s["mean_cas_act_uplift"]


def test_wl1_wl5_cas_act_over_2x(results):
    by = {r.name: r for r in results}
    assert by["WL1"].with_mars.cas_per_act >= 2.0 * by["WL1"].baseline.cas_per_act
    assert by["WL5"].with_mars.cas_per_act >= 2.0 * by["WL5"].baseline.cas_per_act


def test_locality_lost_through_merging():
    """Paper Fig 2: locality at source >> locality at GPU boundary, and
    boundary locality decreases as core count grows."""
    loc = experiment.locality_experiment(core_counts=(24, 64),
                                         reqs_per_core=256)
    w = 512
    assert loc["single_cache"][w] > 2 * loc["gpu_boundary_24cores"][w]
    assert loc["gpu_boundary_24cores"][w] > loc["gpu_boundary_64cores"][w]


def test_locality_grows_with_window():
    loc = experiment.locality_experiment(core_counts=(24,), reqs_per_core=256)
    vals = list(loc["gpu_boundary_24cores"].values())
    assert all(a <= b + 1e-9 for a, b in zip(vals, vals[1:]))


def test_reference_integers_at_rpc_128(results):
    got = {r.name: (r.baseline.cycles, r.baseline.n_act, r.with_mars.cycles,
                    r.with_mars.n_act) for r in results}
    assert got == REFERENCE_128
    s = experiment.summarize(results)
    assert (s["mean_bw_uplift"], s["mean_cas_act_uplift"]) \
        == REFERENCE_128_MEANS


def test_run_all_equals_the_jax_package_field_for_field():
    """RPC 64: every DramResult field of every workload, and the summary,
    equal the JAX package's."""
    want = jexperiment.run_all(reqs_per_core=64)
    got = experiment.run_all(reqs_per_core=64, device="cpu")
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        for part in ("baseline", "with_mars"):
            assert dataclasses.asdict(getattr(g, part)) \
                == dataclasses.asdict(getattr(w, part)), (g.name, part)
    assert experiment.summarize(got) == jexperiment.summarize(want)


def test_locality_equals_the_jax_package():
    kw = dict(core_counts=(24,), windows=(128, 512), reqs_per_core=64)
    assert experiment.locality_experiment(**kw) \
        == jexperiment.locality_experiment(**kw)


def test_run_workload_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        experiment.run_workload("WL1", reqs_per_core=8)


def test_paper_figure_rows(results):
    """Fig 7 / Fig 8 rows under the reference's names, from the results."""
    rows = []

    def emit(name, us, derived=""):
        rows.append((name, derived))
    paper_figures.bench_bandwidth(emit, results)
    paper_figures.bench_cas_act(emit, results)
    names = [n for n, _ in rows]
    assert names == ([f"fig7/bw_uplift/{w}" for w in streams.WORKLOADS]
                     + ["fig7/bw_uplift/mean"]
                     + [f"fig8/cas_act_uplift/{w}" for w in streams.WORKLOADS]
                     + ["fig8/cas_act_uplift/mean"])
    assert dict(rows)["fig7/bw_uplift/mean"] == \
        f"{100 * REFERENCE_128_MEANS[0]:.2f}%"


def test_ablation_grid_is_the_reference_grid():
    got = [(name, v) for name, v, _ in ablations.configs()]
    assert got == ([("request_q", v) for v in (64, 128, 256, 512, 1024)]
                   + [("page_entries", v) for v in (32, 64, 128, 256)]
                   + [("ways", v) for v in (1, 2, 4)]
                   + [("n_ports", v) for v in (1, 2, 8)]
                   + [("mshr", v) for v in (4, 16, 64)])
    cfgs = {(name, v): c for name, v, c in ablations.configs()}
    assert cfgs[("mshr", 4)].mshr_per_core == 4
    assert np.all([c.request_q == 512 for (name, _), c in cfgs.items()
                   if name != "request_q"])


def test_run_all_at_rpc_16_equals_the_jax_package():
    """The batched ``run_all`` (one engine run over the five workloads, one
    DRAM run over their ten streams) at RPC 16: every field and the
    summary equal the JAX package's."""
    want = jexperiment.run_all(reqs_per_core=16)
    got = experiment.run_all(reqs_per_core=16, device="cpu")
    for g, w in zip(got, want):
        assert (g.name, dataclasses.asdict(g.baseline),
                dataclasses.asdict(g.with_mars)) == (
            w.name, dataclasses.asdict(w.baseline),
            dataclasses.asdict(w.with_mars))
    assert experiment.summarize(got) == jexperiment.summarize(want)


ABLATION_RPC = 8       # a reduced sweep: every point still drains


@pytest.fixture(scope="module")
def ablation_rows():
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ablations, "RPC", ABLATION_RPC)
        ablations.run(lambda name, us, derived="": rows.append(
            (name, derived)), device="cpu")
    return rows


def test_ablation_sweep_equals_a_run_all_a_point(ablation_rows):
    """The batched sweep's rows: the reference's names, each point's mean
    uplift equal to ``run_all`` under that point alone."""
    assert [n for n, _ in ablation_rows] == [
        f"ablation/{name}/{v}" for name, v, _ in ablations.configs()]
    for (name, derived), (_, _, cfg) in zip(ablation_rows,
                                            ablations.configs()):
        res = experiment.run_all(mars_cfg=cfg, reqs_per_core=ABLATION_RPC,
                                 device="cpu")
        u = float(np.mean([r.bw_uplift for r in res]))
        assert derived == f"bw_uplift={100*u:.1f}%", name


@pytest.fixture(scope="module")
def sweep_uplifts():
    return ablations.sweep("cpu", ABLATION_RPC)


@pytest.mark.parametrize("point", [("request_q", 64), ("ways", 4),
                                   ("n_ports", 1)])
def test_ablation_point_equals_the_jax_package(sweep_uplifts, point):
    """Three points of the batched sweep (a small RequestQ, four ways, one
    port) against the JAX package's ``run_all`` under the same
    configuration: the same mean uplift, unrounded."""
    from repro.core import mars as jmars
    i = [(name, v) for name, v, _ in ablations.configs()].index(point)
    cfg = ablations.configs()[i][2]
    want = jexperiment.run_all(mars_cfg=jmars.MarsConfig(**cfg.__dict__),
                               reqs_per_core=ABLATION_RPC)
    assert sweep_uplifts[i] == float(np.mean([r.bw_uplift for r in want]))
