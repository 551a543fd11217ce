"""The port's kernel benches (``benchmarks/kernel_benches.py``, the
``kernel_benches`` section of ``benchmarks/run.py``) against the
reference's ``benchmarks/kernel_benches.py``: with ``--device cpu`` the
derived statistics of the gather, scheduler and engine benches equal the
reference's; the MoE run lengths equal the reference's on its weights
converted and the same x.  Timing is not under test: the MoE benches'
timers are stubbed."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.benchmarks import kernel_benches as tbench  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402


ROOT = Path(__file__).resolve().parents[1]


def _reference():
    """The reference's ``benchmarks/kernel_benches.py`` (the checkout's
    root on the path)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("benchmarks.kernel_benches")


def _rows(fn, *args, **kw):
    rows = []
    fn(lambda name, us, derived="": rows.append((name, derived)),
       *args, **kw)
    return rows


def _once(fn, *args, n=5, device=None):
    fn(*args)
    return 1.0


def test_cpu_section_derives_the_reference_s_statistics(capsys,
                                                         monkeypatch):
    """gather (page runs of the same zipf ids), scheduler (unique prefix
    blocks a batch) and engine (S1's twin: WL1's cycles): each derived
    column equal to the reference's, through the runner's section (each
    timed call made once)."""
    monkeypatch.setattr(tbench, "_timeit", _once)
    jbench = _reference()
    assert trun.main(["--only", "kernel_benches", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    got = {ln.split(",")[0]: ln.split(",", 2)[2] for ln in lines[1:]}
    want = dict(_rows(jbench.bench_mars_gather)
                + _rows(jbench.bench_scheduler)
                + _rows(jbench.bench_mars_engine))
    for name, derived in want.items():
        assert got[name] == derived, name
    assert set(got) >= {"moe_dispatch/mars_sorted",
                        "moe_dispatch/einsum_baseline",
                        "moe_dispatch/speedup"}


def test_moe_run_lengths_on_converted_weights(monkeypatch):
    """The reference's bench layer (``moe_init`` from key 0, x from key
    1), converted: the port's router gives the same run lengths."""
    from repro.models import moe as jmoe
    jbench = _reference()
    monkeypatch.setattr(jbench, "_timeit", lambda fn, *a, n=5: 1.0)
    monkeypatch.setattr(tbench, "_timeit", lambda fn, *a, n=5, device=None:
                        1.0)
    want = _rows(jbench.bench_moe_dispatch)
    from repro.models.config import ModelConfig
    cfg = ModelConfig(name="bench", family="moe", n_layers=1, d_model=256,
                      n_heads=4, n_kv_heads=4, d_ff=512, vocab=128,
                      n_experts=32, top_k=2, d_expert=512)
    params = {k: tensor_from_numpy(np.asarray(v)) for k, v in
              jmoe.moe_init(jax.random.key(0), cfg).params.items()}
    x = tensor_from_numpy(np.asarray(
        jax.random.normal(jax.random.key(1), (2048, cfg.d_model))))
    got = _rows(tbench.bench_moe_dispatch, "cpu", params=params, x=x)
    assert [r for r in got if "run_len" in r[1]] == \
        [r for r in want if "run_len" in r[1]]
    assert [r[0] for r in got] == [r[0] for r in want]


def test_held_refuses_a_kernel_off_its_twin():
    """``held`` keeps the largest difference of a kernel's output from
    its twin's and raises beyond the tolerance, or on a shape or dtype
    the twin does not give."""
    want = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = want.clone()
    got[1, 2] += 0.25
    assert tbench.held("row", got, want, 0.25) == 0.25
    assert tbench.TWIN_ERR["row"] == 0.25
    with pytest.raises(AssertionError, match="from its twin"):
        tbench.held("row", got, want, 0.125)
    with pytest.raises(AssertionError, match="from its twin"):
        tbench.held("row", got * float("nan"), want, 1.0)
    for bad in (got.to(torch.bfloat16), got.reshape(3, 2)):
        with pytest.raises(AssertionError, match="against its twin's"):
            tbench.held("row", bad, want, 1.0)
