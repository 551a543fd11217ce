"""Two pieces of ``chip_smoke.py`` on smoke serve runs.

``raw_rows``, the profile reader of the serve summaries and the kernel
phases, read from the profiler's raw events, against ``key_averages``
(which builds the event tree): every host op's summed self time agrees
(to 1e-6 relative: both sum the same nanosecond durations), and so does
every device row's summed time and count where a card is present; a
CPU-only profile has no device row.

``routed_layer_check``, which holds a bf16 MoE run's routed layer
against float32 math on the run's own expert choices: it passes the
dispatch and catches a broken one.

``mirror_check``, which holds a tiered run's promoted blocks in the
staged device mirror (and the host pool) against their tier payloads
bit for bit: it passes a tiered smoke run, in bfloat16 and with an fp8
pool, and catches a mirror page or a payload that differs.  On the card
``dispatch_order_check`` holds a sharded smoke run's dispatches free of
blocking CUDA calls.

``metrics_check``, which reads a telemetry run's ``metrics.json`` and
``trace.jsonl``: it passes each of the four telemetry runs' smoke
counterparts and prints their line, and catches a trace whose write-back
lands before its sync, a request that never frees, a promotion of a
block never demoted, a batch over its class quota, a run that never
pauses, and an empty phase histogram; the host rows of a profiled run
with telemetry on read as ``key_averages`` reads them.

The ``sim`` phase's host-side helpers: its comparison of the simulated
benchmark rows with ``results/bench_baseline.json`` passes the port's CPU
rows and catches a changed or missing row; its two kernel rows
(``mars_engine``, ``dram_channel``) carry every key of the kernels line
and name the reference's ``jax.lax.scan`` lines; its host twins agree
with the oracle and with ``dram.simulate``.

The ``train`` phase's host-side helpers: the launch counts a training
step must show, B5's bound, the CUDA refusals (which need no card) and
the kernel rows' ``replaces`` lines; on the card, B5 against its twin
within ``B5_TOL`` and B2 bitwise against its twin on host copies."""
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(1)


def _profiled_serve(device: str):
    """A profiled paged serve run: the smoke config on the CPU; on the
    card qwen1.5-0.5b at full width, whose head dim K1 takes."""
    from torch.profiler import ProfilerActivity, profile
    model = ["--smoke"] if device == "cpu" else ["--config", "qwen1_5_0_5b"]
    argv = ["--paged", *model, "--device", device, "--requests", "4",
            "--batch", "2", "--new-tokens", "2", "--parity-checks", "0"]
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        serve.main(argv)
        if device == "cuda":
            torch.cuda.synchronize()
    return prof


def _assert_rows(rows, want: dict):
    got = {r["name"]: r["ms"] for r in rows}
    assert got.keys() == want.keys()
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms, rel=1e-6, abs=1e-6), name
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows),
                                             reverse=True)


def _check_against_key_averages(prof):
    """``raw_rows`` (and ``device_rows``, which the kernel phases read)
    of ``prof`` equal ``key_averages``' rows; returns the device rows."""
    from torch.autograd import DeviceType
    dev, host = chip_smoke.raw_rows(prof)
    assert chip_smoke.device_rows(prof) == dev
    want_host, want_dev, want_calls = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                want_dev[e.key] = us / 1e3
                want_calls[e.key] = e.count
        elif e.self_cpu_time_total > 0:
            want_host[e.key] = e.self_cpu_time_total / 1e3
    _assert_rows(host, want_host)
    _assert_rows(dev, want_dev)
    assert {r["name"]: r["calls"] for r in dev} == want_calls
    return dev


def test_raw_rows_match_key_averages_on_the_host():
    assert _check_against_key_averages(_profiled_serve("cpu")) == []


@pytest.mark.cuda
def test_raw_rows_match_key_averages_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device rows exist only there")
    assert _check_against_key_averages(_profiled_serve("cuda")), \
        "a card's profile of a serve run has device rows"


def _served_moe_bf16():
    out = serve.main(["--paged", "--config", "kimi_k2_1t_a32b", "--smoke",
                      "--device", "cpu", "--requests", "4", "--batch", "2",
                      "--new-tokens", "8", "--dtype", "bfloat16",
                      "--parity-checks", "0"])
    assert out["cfg"].is_moe and out["cfg"].cdtype == torch.bfloat16
    return out


_GROUPED_FFN = moe._grouped_ffn


def _rolled_experts(tokens, local_ids, w_in, w_gate, w_out, n_local, act,
                    **kw):
    """A dispatch that reads each expert's neighbour's up-projection."""
    return _GROUPED_FFN(tokens, local_ids, w_in.roll(1, 0), w_gate, w_out,
                        n_local, act, **kw)


def _one_row_zeroed(*args, **kw):
    """A dispatch that loses the output of one assignment."""
    y = _GROUPED_FFN(*args, **kw).clone()
    y[0] = 0
    return y


@pytest.mark.parametrize("fault", [None, _rolled_experts, _one_row_zeroed])
def test_routed_layer_check_holds_k4_apart_from_router_ties(fault,
                                                            monkeypatch):
    """``routed_layer_check`` on a bf16 MoE serve run (kimi-k2 smoke): on
    the CPU the dispatch's plain twin sits within ``ROUTED_NOISE_FACTOR``
    of the plain bf16 math's distance from float32 (both are the same
    arithmetic here), and a dispatch that reads the wrong expert's weights
    or loses one assignment's output is far outside it."""
    out = _served_moe_bf16()
    if fault is not None:
        monkeypatch.setattr(moe, "_grouped_ffn", fault)
    r = chip_smoke.routed_layer_check(torch, out["cfg"], out)
    assert r["tokens"] == 4 * (24 + 8)
    assert 0 < r["plain_max_rel"] < 0.05
    limit = chip_smoke.ROUTED_NOISE_FACTOR * r["plain_max_rel"]
    if fault is None:
        assert r["k4_max_rel"] <= limit
    else:
        assert r["k4_max_rel"] > 10 * limit


TIERED_SMOKE = ["--paged", "--smoke", "--requests", "24", "--prefixes", "12",
                "--pool-blocks", "12", "--batch", "4", "--new-tokens", "3",
                "--parity-checks", "0", "--tiered-kv"]


def test_flag_value_reads_the_last_occurrence():
    assert chip_smoke.flag_value((), "--requests", 16) == 16
    assert chip_smoke.flag_value(chip_smoke.TIERED, "--requests", 16) == 64
    assert chip_smoke.flag_value(chip_smoke.TIERED + ("--requests", "5"),
                                 "--requests", 16) == 5
    assert chip_smoke.flag_value(chip_smoke.SHARDED, "--shards", 1) == 4


def _tiered_run(monkeypatch, fp8: bool):
    import dataclasses
    if fp8:
        config = serve._config
        monkeypatch.setattr(serve, "_config", lambda a: dataclasses.replace(
            config(a), kv_dtype="float8_e4m3fn"))
    with chip_smoke.Promotions() as promoted:
        out = serve.main(TIERED_SMOKE + ["--device", "cpu"])
    assert out["tiers"]["promotes"] > 0
    return out, promoted


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("fault", [None, "mirror", "payload"])
def test_mirror_check_holds_promoted_pages_to_their_payload(fp8, fault,
                                                            monkeypatch):
    out, promoted = _tiered_run(monkeypatch, fp8)
    backend = out["backend"]
    dsts = promoted.dsts[id(backend.tiers)]
    assert dsts and set(dsts) <= set(range(backend.pool.cfg.num_blocks))
    if fault is not None:
        k_dev, _ = backend._staged_pages()
        live = next(d for d in dsts if backend.prefix._by_bid.get(d))
        if fault == "mirror":
            # a mirror page that misses one upload: the next staging
            # writes only dirty blocks, so the corruption stays
            k_dev.view(torch.uint8)[:, live].bitwise_xor_(1)
            backend._slot = backend._staged_slot
        else:
            key = backend.prefix._by_bid[live]
            entry = next(t._entries[key] for t in backend.tiers.tiers
                         if t.holds(key))
            entry.k.view(torch.uint8).bitwise_xor_(1)
        with pytest.raises(AssertionError, match="differ"):
            chip_smoke.mirror_check(torch, backend, promoted)
        return
    r = chip_smoke.mirror_check(torch, backend, promoted)
    assert r["blocks"] > 0
    assert r["dtype"] == ("torch.float8_e4m3fn" if fp8 else
                          "torch.bfloat16")


def test_mirror_check_needs_a_promoted_block():
    out = serve.main(TIERED_SMOKE[:-1] + ["--device", "cpu"])
    with pytest.raises(AssertionError, match="0 promoted blocks"):
        chip_smoke.mirror_check(torch, out["backend"], chip_smoke.Promotions())


@pytest.mark.cuda
def test_dispatch_order_check_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the check profiles CUDA calls")
    out = serve.main(["--paged", "--config", "qwen1_5_0_5b", "--shards", "2",
                      "--device", "cuda", "--requests", "4", "--batch", "4",
                      "--new-tokens", "2", "--parity-checks", "0"])
    r = chip_smoke.dispatch_order_check(torch, out)
    assert r["blocking"] == {} and r["last_dispatch_before_logits"]


# ---------------------------------------------------------------------------
# the telemetry runs' checks
# ---------------------------------------------------------------------------

def _metrics_run(tag: str, tmp_path):
    """A ``chip_smoke.METRICS_SMOKES`` run at the smoke config on the CPU,
    its files under ``tmp_path``."""
    flags = chip_smoke.metrics_flags(tag, str(tmp_path))
    out = serve.main(["--paged", "--smoke", "--device", "cpu",
                      "--parity-checks", "1", *flags])
    return out, flags


@pytest.mark.parametrize("tag", sorted(chip_smoke.METRICS_SMOKES))
def test_metrics_check_passes_the_telemetry_runs(tag, tmp_path, capsys):
    """``metrics_check`` passes each telemetry run's own output, reads
    its lag from the races replay, and prints the host phases, the
    trace's kept and dropped events, the modelled row-hit % and
    tokens/s."""
    out, flags = _metrics_run(tag, tmp_path)
    r = chip_smoke.metrics_check(out, tag, flags)
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith(f"[metrics {tag}] host ms p50/p99 (mean): step ")
    for word in ("dispatch", "sync", "commit", "rest of step", "kept",
                 "dropped 0", "(modelled", "0 violations", "tokens/s"):
        assert word in line, word
    assert r["races"]["lag_tokens"] > 0 and r["trace"]["dropped"] == 0
    assert set(r["phases_ms"]) == {"step", "dispatch", "sync", "commit"}
    assert r["kept"] == r["trace"]["events"]
    assert 0.0 <= r["row_hit_pct_modelled"] <= 100.0
    if tag == "classes":
        assert sorted(set(out["max_new"].values())) == [6, 12, 24]


def _rewrite(path, fn):
    evs = [json.loads(line) for line in path.read_text().splitlines()]
    path.write_text("".join(json.dumps(e) + "\n" for e in fn(evs)))


def _swap_first_sync_commit(evs):
    """A write-back that lands before its logits: the first commit's
    stamp moved ahead of its step's sync."""
    c = next(e for e in evs if e["ev"] == "backend.commit")
    d = next(e for e in evs if e["ev"] == "backend.decode"
             and e["step"] == c["step"] and e["shard"] == c["shard"])
    c["ts"] = d["ts"] - 1
    return sorted(evs, key=lambda e: e["ts"])


FAULTS = {
    "commit_before_sync": ("plain", _swap_first_sync_commit, "races"),
    "no_free": ("plain", lambda evs: [e for e in evs
                                      if e["ev"] != "engine.free"],
                "in order"),
    "promote_without_demote": ("tiered", lambda evs: [
        e for e in evs if e["ev"] != "tier.demote"], "not demoted"),
    "over_quota": ("classes", lambda evs: [
        dict(e, classes={k: v + 99 for k, v in e["classes"].items()})
        if e["ev"] == "sched.batch" else e for e in evs], "over quota"),
    "resume_without_pause": ("classes", lambda evs: [
        e for e in evs if e["ev"] != "engine.pause"], "no engine.pause"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_metrics_check_catches_a_broken_trace(fault, tmp_path):
    tag, fn, match = FAULTS[fault]
    out, flags = _metrics_run(tag, tmp_path)
    _rewrite(tmp_path / tag / "trace.jsonl", fn)
    with pytest.raises(AssertionError, match=match):
        chip_smoke.metrics_check(out, tag, flags)


def test_metrics_check_catches_an_empty_phase_histogram(tmp_path):
    out, flags = _metrics_run("pipeline", tmp_path)
    path = tmp_path / "pipeline" / "metrics.json"
    snap = json.loads(path.read_text())
    snap["histograms"]["engine.sync_ms"]["count"] = 0
    path.write_text(json.dumps(snap))
    with pytest.raises(AssertionError, match="engine.sync_ms"):
        chip_smoke.metrics_check(out, "pipeline", flags)


def test_raw_rows_match_key_averages_on_a_metrics_run(tmp_path):
    """The host rows of a profiled serve run with telemetry on."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve.main(["--paged", "--smoke", "--device", "cpu", "--requests",
                    "4", "--batch", "2", "--new-tokens", "2",
                    "--parity-checks", "0",
                    *chip_smoke.metrics_flags("plain", str(tmp_path))])
    assert _check_against_key_averages(prof) == []


# ---------------------------------------------------------------------------
# the sim phase's host-side helpers
# ---------------------------------------------------------------------------

def _sim_rows():
    from repro_torch.benchmarks import kvcache_sim
    rows = []
    kvcache_sim.run(lambda name, us, derived="": rows.append(
        dict(name=name, us_per_call=us, derived=derived)), smoke=True,
        device="cpu")
    return rows


def test_sim_baseline_check_passes_the_rows_and_catches_a_change(tmp_path):
    rows = _sim_rows()
    assert chip_smoke.sim_baseline_check(rows) == []
    base = json.loads((ROOT / "results" / "bench_baseline.json").read_text())
    base["kvcache/placement/sharded/gbps/shards2"] = 101.8
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(base))
    diff = chip_smoke.sim_baseline_check(rows, path)
    assert len(diff) == 1 and "sharded/gbps/shards2" in diff[0]
    rows = [r for r in rows if "tier/promote/naive" not in r["name"]]
    assert len(chip_smoke.sim_baseline_check(rows)) == 1


def test_sim_kernel_rows_list_the_new_kernels():
    """Two rows, mars_engine and dram_channel, with every key of the
    kernels line, their sources in the port, and ``replaces`` naming the
    reference's ``jax.lax.scan`` lines."""
    timing = {name: dict(ms=1.0, plain_ms=2.0, bound_ms=1e-4,
                         bound_by="bytes", serial_steps=10, ns_per_step=1e5)
              for name, _, _ in chip_smoke.SIM_KERNELS}
    counts = {name: 0 for name, _, _ in chip_smoke.SIM_KERNELS}
    launches = {chip_smoke.SIM_PATH: dict(counts, mars_engine=5,
                                          dram_channel=10),
                "qwen1_5_0_5b": counts}
    rows = chip_smoke.sim_kernel_rows(launches, timing)
    assert [r["name"] for r in rows] == ["mars_engine", "dram_channel"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for r in rows:
        assert keys <= set(r)
        assert r["route"] == "cuda" and r["library_ms"] is None
        assert (ROOT / r["source"]).is_file()
        path, line = r["replaces"].split(":")
        assert "jax.lax.scan" in (ROOT / path).read_text().splitlines()[
            int(line) - 1]
    assert [r["launches"] for r in rows] == [5, 10]
    assert rows[0]["launches_by_path"] == {chip_smoke.SIM_PATH: 5,
                                           "qwen1_5_0_5b": 0}
    assert set(chip_smoke.KERNEL_NAMES) == set(chip_smoke.kernel_counters())


def test_sim_twins_agree_with_the_port_on_the_host():
    """The phase's host twins: S1's on a random stream equals the oracle,
    S2's on ``simulate``'s operands equals ``simulate`` (CPU)."""
    import numpy as np
    from repro_torch.core import dram, mars
    name, addr, ports, src, cfg = chip_smoke.sim_random_streams()[1]
    perm, stalls, total, _ = chip_smoke.sim_plain_mars(addr, ports, src, cfg)
    np.testing.assert_array_equal(
        perm, mars.mars_reorder_reference(addr, ports, cfg, src))
    assert total >= len(addr) and stalls > 0
    addr, _, _, wr = chip_smoke.sim_streams("WL3", 16)
    cfg = dram.DramConfig(window=8)
    ops = chip_smoke.sim_channel_operands(torch, addr, wr, cfg, "cpu")
    rows, _ = chip_smoke.sim_plain_channels(ops, cfg)
    res = dram.simulate(addr, cfg, wr, device="cpu")
    assert tuple(r[0] for r in rows) == res.per_channel_cycles
    assert sum(r[1] for r in rows) == res.n_act
    assert chip_smoke.sim_bytes_channels(ops) == 5 * len(addr) + 8 * 3 + 24


def test_train_launches_wanted_per_step():
    """The train phase's launch counts a step, remat off: K5 once per
    attention (qwen's 24 causal layers; whisper's 6 encoder, 6 decoder
    and 6 cross-attention layers), B5 ``BWD_LAUNCHES`` (3) times as
    often, K2 and B2 once (both tables exceed 2**22 elements)."""
    from repro_torch import configs
    counters = chip_smoke.kernel_counters()
    for arch, attn in (("qwen1_5_0_5b", 24), ("whisper_base", 18)):
        want = chip_smoke.train_launches_wanted(configs.get(arch), 5,
                                                counters)
        assert set(want) == set(counters)
        assert want["flash_attention"] == 5 * attn
        assert want["flash_attention_bwd"] == 5 * attn * 3
        assert want["gather_rows"] == want["embedding_grad_scatter"] == 5
        assert sum(want.values()) == 5 * (4 * attn + 2)
    assert set(chip_smoke.TRAIN_KERNELS) <= set(counters)


def test_b5_bound_counts_the_kept_pairs():
    """qwen's training attention: 8 x 16 heads of 512 causal positions
    keep 512 * 513 / 2 pairs a head, 10 * 64 operations each (10.8
    GFLOP); in bf16 its 67 MB of operands bind (20 us against 11 us of
    the tensor cores), in float32 the CUDA cores' 67 TFLOP/s do."""
    q = torch.zeros(8, 512, 16, 64, dtype=torch.bfloat16)
    b = chip_smoke.b5_bound(q, q, True, "bfloat16")
    assert b["pairs"] == 8 * 16 * 512 * 513 // 2
    assert b["ops"] == 10 * 64 * b["pairs"]
    assert b["bytes"] == 8 * q.numel() * 2
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    f = chip_smoke.b5_bound(q.float(), q.float(), True, "float32")
    assert f["bound_by"] == "operations"
    assert f["bound_ms"] == pytest.approx(f["ops"] / 67e12 * 1e3)
    nc = chip_smoke.b5_bound(q[:, :100], q, False, "float32")
    assert nc["pairs"] == 8 * 16 * 100 * 512


def test_train_refusals_need_no_card():
    """``launch.train`` refuses the configs whose forward launches K3 or
    K4 on CUDA before it builds anything, with or without a card."""
    assert chip_smoke.train_refusals() == list(chip_smoke.TRAIN_REFUSED)


def test_train_kernel_rows_list_the_backward_kernels():
    """Two rows, flash_attention_bwd (B5) and embedding_grad_scatter
    (B2), with every key of the kernels line, their sources in the port,
    launches on the training main path, and ``replaces`` naming the
    reference functions they take the place of: ``layers.sdpa`` (which
    the JAX trainer differentiates) and ``embedding_grad_scatter``."""
    t = dict(ms=1.0, plain_ms=2.0, bound_ms=0.1, bound_by="bytes",
             library_ms=0.5)
    record = {"b5_timing": {"qwen/bfloat16": t},
              "b2_timing": {"qwen/zipf/bfloat16": dict(t, library_ms=0.2)},
              "b2_cases": [dict(host_err=0.0), dict(host_err=0.0)]}
    counts = {k: 0 for k in chip_smoke.kernel_counters()}
    launches = {chip_smoke.TRAIN_PATH: dict(
        counts, flash_attention_bwd=2160, embedding_grad_scatter=30),
        "qwen1_5_0_5b": counts}
    rows = chip_smoke.train_kernel_rows(launches, record, 3e-3)
    assert [r["name"] for r in rows] == ["flash_attention_bwd",
                                         "embedding_grad_scatter"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    heads = ["def sdpa(", "def embedding_grad_scatter("]
    for r, head in zip(rows, heads):
        assert keys <= set(r) and r["route"] == "cuda"
        assert (ROOT / r["source"]).is_file()
        path, line = r["replaces"].split(":")
        assert (ROOT / path).read_text().splitlines()[int(line) - 1] \
            .startswith(head)
    assert [r["launches"] for r in rows] == [2160, 30]
    assert [r["max_abs_err"] for r in rows] == [3e-3, 0.0]
    assert [r["library_ms"] for r in rows] == [0.5, 0.2]
    assert rows[0]["launches_by_path"] == {chip_smoke.TRAIN_PATH: 2160,
                                           "qwen1_5_0_5b": 0}


@pytest.mark.parametrize("short", [0, 2, 9])
def test_counted_ms_reads_only_whole_profiles(short, monkeypatch):
    """``counted_ms`` takes a profile only when it holds every launch
    (per_call x reps of the kernel): a short one is profiled again, and
    after four short ones the time comes from CUDA events, never from a
    short profile."""
    seen = []

    def profile(fn, reps, case, need=(), tries=4):
        seen.append(1)
        whole = len(seen) > short
        return [dict(name="flash_bwd_dq", ms=2.0,
                     calls=3 * reps - (0 if whole else 1)),
                dict(name="memset", ms=0.5, calls=reps)]
    monkeypatch.setattr(chip_smoke, "device_profile", profile)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: 7.0)
    got = chip_smoke.counted_ms(lambda: None, 10, "case", "flash_bwd_", 3)
    if short < 4:
        assert got == 2.5 and len(seen) == short + 1
    else:
        assert got == 7.0 and len(seen) == 4


@pytest.mark.parametrize("short", [0, 3, 4])
def test_counted_rows_never_return_a_short_profile(short, monkeypatch):
    """``counted_rows``, which K1's, K3's and K5's timings read through,
    returns a profile's rows only when it holds every launch of the
    kernel key, profiling again while one is short, and None after four
    short ones (the caller then times with CUDA events); ``launches_of``
    reads a call's launches from the wrapper's counts."""
    seen = []

    def profile(fn, reps, case, need=(), tries=4):
        seen.append(1)
        calls = 2 * reps - (0 if len(seen) > short else 1)
        return [dict(name="paged_attention_split_kernel", ms=1.0,
                     calls=calls)]
    monkeypatch.setattr(chip_smoke, "device_profile", profile)
    rows = chip_smoke.counted_rows(lambda: None, 5, "case",
                                   "paged_attention_", 2)
    assert (rows is None) == (short >= 4)
    assert len(seen) == min(short + 1, 4)

    class Wrapper:
        launches = 3
        merge_launches = 0

    def call():
        Wrapper.launches += 1
        Wrapper.merge_launches += 1
    assert chip_smoke.launches_of(call, (Wrapper, "launches"),
                                  (Wrapper, "merge_launches")) == 2


@pytest.mark.parametrize("causal", [True, False])
def test_b5_bounds_hold_rounding_flips_and_catch_a_fault(causal):
    """``b5_bounds`` on the host, bf16: the twin against itself with its
    lse moved by 1e-6 relative (which flips the bf16 rounding of some p
    and ds, as B5's other summation order does on the card) stays within
    the bound though not within ``B5_TOL`` alone; a dv row given to the
    wrong key, or a dq 2 % off, does not.  ``bf16_flip`` flags a value at
    a bf16 rounding midpoint and not one off it.  In
    float32 the bound is ``B5_TOL``'s."""
    from repro_torch.kernels.flash_attention import flash_attention as k5
    gen = torch.Generator().manual_seed(4)
    B, S, H, D = 2, 96, 2, 64
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen).bfloat16()
                   for _ in range(4))
    o, lse = k5.flash_attention_with_lse(q, k, v, causal=causal)
    want = k5.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        lse=lse)
    moved = k5.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         lse=lse * (1 + 1e-6))
    bounds = chip_smoke.b5_bounds(k5, q, k, v, o, do, lse, causal, want)
    assert any(chip_smoke.bwd_err(m, w, chip_smoke.B5_TOL["bfloat16"])[1]
               > 1.0 for m, w in zip(moved, want))
    for m, w, b in zip(moved, want, bounds):
        assert chip_smoke.bound_err(m, w, b)[1] <= 1.0
    dv = want[2].clone()
    dv[:, [3, 4]] = dv[:, [4, 3]]
    assert chip_smoke.bound_err(dv, want[2], bounds[2])[1] > 1.0
    dq = (want[0].float() * 1.02).bfloat16()
    assert chip_smoke.bound_err(dq, want[0], bounds[0])[1] > 1.0
    x = torch.tensor([1.0, 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9])
    assert chip_smoke.bf16_flip(torch, x, x * 2.0 ** -16).tolist() == [
        0.0, 2.0 ** -7 + (1.0 + 2.0 ** -8) * 2.0 ** -16, 0.0]
    f32 = [t.float() for t in (q, k, v, o, do)]
    want32 = k5.flash_attention_bwd_plain(*f32, causal=causal, lse=lse)
    b32 = chip_smoke.b5_bounds(k5, *f32, lse, causal, want32)
    for w, b in zip(want32, b32):
        atol, rtol = chip_smoke.B5_TOL["float32"]
        assert torch.allclose(b, atol * w.abs().max() + rtol * w.abs())


@pytest.mark.parametrize("causal", [True, False])
def test_f32_reference_err_holds_bf16_gradients_to_the_unrounded_twin(
        causal):
    """``f32_reference_err`` on the host: the bf16 rounding twin's
    gradients (B5's arithmetic) and SDPA backward's on the same bf16
    inputs, each against the unrounded float32 twin; both within a few
    bf16 spacings (relative rms below 1e-2), and a gradient scaled by 2
    far from it."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as k5
    gen = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(1, 48, 2, 64, generator=gen).bfloat16()
                   for _ in range(4))
    o, lse = k5.flash_attention_with_lse(q, k, v, causal=causal)
    got = k5.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                       lse=lse)
    ref = chip_smoke.f32_reference_err(torch, F, k5, q, k, v, do, got,
                                       causal)
    assert set(ref) == {"b5", "sdpa", "ratio", "b5_rms", "sdpa_rms"}
    assert max(ref["b5_rms"]) < 1e-2 and max(ref["sdpa_rms"]) < 1e-2
    assert 0.25 < ref["ratio"] < 4.0
    off = chip_smoke.f32_reference_err(torch, F, k5, q, k, v, do,
                                       [g * 2 for g in got], causal)
    assert min(off["b5_rms"]) > 0.5 and off["ratio"] > 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,D,causal", [
    (2, 130, 130, 3, 64, True), (2, 70, 200, 2, 64, False),
    (1, 100, 100, 2, 128, True)])
def test_b5_matches_its_twin_on_the_card(B, Sq, Sk, H, D, causal, dtype):
    """B5 on the card against its plain twin on the same inputs (o and
    the rows' lse from K5), held to the train phase's bound per element
    (``b5_bounds``: ``B5_TOL``, and in bf16 the flips of the rounded p
    and ds); each call launches ``BWD_LAUNCHES`` kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B5 runs only there")
    from repro_torch.kernels.flash_attention import flash_attention as k5
    gen = torch.Generator("cuda").manual_seed(2)
    dt = getattr(torch, dtype)
    q, k, v = chip_smoke.k5_inputs(torch, gen, B, Sq, Sk, H, D, dt)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
    o, lse = k5.flash_attention_with_lse(q, k, v, causal=causal)
    before = k5.flash_attention_bwd.launches
    got = k5.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert k5.flash_attention_bwd.launches == before + k5.BWD_LAUNCHES
    want = k5.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                        lse=lse)
    bounds = chip_smoke.b5_bounds(k5, q, k, v, o, do, lse, causal, want)
    for g, w, b in zip(got, want, bounds):
        assert g.dtype == dt and g.shape == w.shape
        assert chip_smoke.bound_err(g, w, b)[1] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b2_equals_its_twin_on_host_copies(dtype):
    """B2 on the card, on TokenStream's zipf ids (long runs, unused
    rows), equals its twin on host copies bit for bit and launches once
    a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2 runs only there")
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels.mars_gather import mars_gather as mg
    from repro_torch.kernels.mars_gather import ops
    V, D = 5000, 520
    ids = torch.from_numpy(next(TokenStream(DataConfig(
        vocab=V, seq_len=300, global_batch=4)))["tokens"])
    g = torch.randn(4, 300, D, generator=torch.Generator().manual_seed(3)) \
        .to(getattr(torch, dtype))
    before = mg.scatter_add_rows.launches
    got = ops.embedding_grad_scatter(ids.cuda(), g.cuda(), V)
    torch.cuda.synchronize()
    assert mg.scatter_add_rows.launches == before + 1
    want = ops.embedding_grad_scatter(ids, g, V)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_a_gradient_on_the_card():
    """K3's and K4's wrappers on the card raise, without launching, for
    an input that needs a gradient, and launch under ``no_grad``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 and K4 run only there")
    assert chip_smoke.kernel_grad_refusals(torch) == ["ssd_scan",
                                                       "grouped_matmul"]
