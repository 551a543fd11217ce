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
step must show (the MoE smoke configs' K4 and B4 too), B5's and B4's
bounds, the CUDA refusals for memory (which need no card) and the bytes
per device they print, the expert-parallel MoE check's column shapes,
launches and comparison with the one-process layer, the kernel
rows' ``replaces`` lines, B4's cases (the published widths, a skewed and
an empty routing, the edges) and the router comparison of the float32
MoE step; on the card, B5 against its twin within ``B5_TOL``, B2 bitwise
against its twin on host copies, and K4 and K3 with a gradient to take
launching their backward kernels.

The ``dryrun`` phase's pieces: each training run's model-flop floor,
the floor check that refuses a step shorter than ``model_flops /
PEAK_FLOPS``, the kernel benches' derived statistics compared across
devices (the wall-clock speedup row aside), the production cell's
status, and a failing part that fails the run: ``main`` lets it out."""
import dataclasses
import json
import sys
import types
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
    kernels line (and the chain bound and the batched call's ms), their
    sources in the port, ``replaces`` naming the reference's
    ``jax.lax.scan`` lines, and one launch each on the main path and the
    sweep."""
    timing = {name: dict(ms=1.0, plain_ms=2.0, bound_ms=1e-4,
                         bound_by="bytes", serial_steps=10, ns_per_step=1e5,
                         chain_bound_ms=0.5, batched_ms=1.2,
                         batched_instances=5, batched_chain_bound_ms=0.6)
              for name, _, _ in chip_smoke.SIM_KERNELS}
    counts = {name: 0 for name, _, _ in chip_smoke.SIM_KERNELS}
    launches = {chip_smoke.SIM_PATH: dict(counts, mars_engine=1,
                                          dram_channel=1),
                chip_smoke.SIM_SWEEP: dict(counts, mars_engine=1,
                                           dram_channel=1),
                "qwen1_5_0_5b": counts}
    rows = chip_smoke.sim_kernel_rows(launches, timing)
    assert [r["name"] for r in rows] == ["mars_engine", "dram_channel"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "chain_bound_ms", "batched_ms"}
    for r in rows:
        assert keys <= set(r)
        assert r["route"] == "cuda" and r["library_ms"] is None
        assert (ROOT / r["source"]).is_file()
        path, line = r["replaces"].split(":")
        assert "jax.lax.scan" in (ROOT / path).read_text().splitlines()[
            int(line) - 1]
    assert [r["launches"] for r in rows] == [1, 1]
    assert rows[0]["launches_by_path"] == {chip_smoke.SIM_PATH: 1,
                                           chip_smoke.SIM_SWEEP: 1,
                                           "qwen1_5_0_5b": 0}
    assert rows[0]["chain_bound_ms"] == 0.5 and rows[1]["batched_ms"] == 1.2
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


def test_sim_batched_helpers_on_the_host():
    """The sim phase's batched operands: streams laid back to back give
    each stream's channel rows, as ``simulate_many`` does; an instance's
    byte count is its operands' bytes plus the permutation's."""
    import numpy as np
    from repro_torch.core import dram, mars
    from repro_torch.kernels.dram_channel import dram_channel as dc
    cfg = dram.DramConfig(window=8)
    ss = [chip_smoke.sim_streams(wl, 4)[::3] for wl in ("WL1", "WL2")]
    ss += [(a, w) for _, _, a, w in chip_smoke.sim_short_streams()[:1]]
    ss += [(np.zeros(0, np.int32), None)]
    ops = [chip_smoke.sim_channel_operands(torch, a, w, cfg, "cpu")
           for a, w in ss]
    big = chip_smoke.sim_concat_operands(torch, ops)
    rows = dc.dram_channels(*big, cfg).tolist()
    assert rows == sum((dc.dram_channels(*o, cfg).tolist() for o in ops), [])
    assert [tuple(r) for r in rows[2:4]] == \
        chip_smoke.sim_plain_channels(ops[1], cfg)[0]
    inst = chip_smoke.sim_instance(torch, *chip_smoke.sim_streams(
        "WL1", 4)[:3], mars.MarsConfig(), "cpu")
    n = inst[0].numel()
    assert chip_smoke.sim_bytes_mars(inst) == \
        16 * n + 4 * inst[1].numel() + 4 * 8 + 12


def test_train_launches_wanted_per_step():
    """The train phase's launch counts a step, remat off: K5 once per
    attention (qwen's 24 causal layers; whisper's 6 encoder, 6 decoder
    and 6 cross-attention layers; hymba's 2 global layers), B5
    ``BWD_LAUNCHES`` (3) times as often, K2 and B2 once (every table
    exceeds 2**22 elements); K3 once per SSM layer (mamba2 48, hymba 32)
    with its two passes each at 8 chunks of 64 and B3's 3 launches each,
    none of them at one chunk but B3's 2."""
    from repro_torch import configs
    counters = chip_smoke.kernel_counters()
    for arch, attn, ssm in (("qwen1_5_0_5b", 24, 0), ("whisper_base", 18, 0),
                            ("mamba2_370m", 0, 48), ("hymba_1_5b", 2, 32)):
        want = chip_smoke.train_launches_wanted(configs.get(arch), 5,
                                                counters)
        assert set(want) == set(counters)
        assert want["flash_attention"] == 5 * attn
        assert want["flash_attention_bwd"] == 5 * attn * 3
        assert want["gather_rows"] == want["embedding_grad_scatter"] == 5
        assert want["ssd_scan"] == 5 * ssm
        assert want["ssd_scan_passes"] == 5 * 2 * ssm
        assert want["ssd_scan_bwd"] == 5 * 3 * ssm
        assert sum(want.values()) == 5 * (4 * attn + 2 + 6 * ssm)
        one = chip_smoke.train_launches_wanted(configs.get(arch), 1,
                                               counters, seq=64)
        assert one["ssd_scan_passes"] == 0
        assert one["ssd_scan_bwd"] == 2 * ssm
        assert want["grouped_matmul"] == want["grouped_matmul_bwd"] == 0
    assert set(chip_smoke.TRAIN_KERNELS) <= set(counters)


def test_tp_launches_wanted_a_rank():
    """The tensor-parallel check's launches a rank: a training step's are
    the one-process step's (a rank's cut runs every kernel once, on its
    heads and vocabulary rows); a serve run's are K5 once a layer in the
    prefill (qwen 24, paligemma 18) and K2 in the prefill and each of
    its 8 decode steps, the rank's half of each table holding more than
    2**22 elements; a smoke table's half holds fewer: no K2."""
    from repro_torch import configs
    counters = chip_smoke.kernel_counters()
    qwen = configs.get("qwen1_5_0_5b")
    assert chip_smoke.tp_launches_wanted(qwen, counters, "train", 3) == \
        chip_smoke.train_launches_wanted(qwen, 3, counters)
    B, S, n = chip_smoke.TP_PROMPTS
    for arch, layers in (("qwen1_5_0_5b", 24), ("paligemma_3b", 18)):
        want = chip_smoke.tp_launches_wanted(configs.get(arch), counters,
                                             "serve", decodes=n)
        assert {k: v for k, v in want.items() if v} == {
            "flash_attention": layers, "gather_rows": 1 + n}
    smoke = chip_smoke.tp_launches_wanted(configs.get_smoke("qwen1_5_0_5b"),
                                          counters, "serve", decodes=n)
    assert smoke["gather_rows"] == 0
    assert chip_smoke.TP_F32_TOL <= 1e-4 and chip_smoke.TP_RANKS == 2


def test_vlm_launches_wanted_with_and_without_its_image_prefix():
    """paligemma-3b's training run reads stub image frames: the prefix
    mask sends all 18 layers to the plain masked softmax, so a step
    launches no K5 and no B5, and K2 and B2 once (its 257216 x 2048
    table); its text-only float32 step (``image_prefix=False``, the
    first ``F32_LAYERS`` layers) launches K5 once a layer and B5 three
    times as often."""
    from repro_torch import configs
    from repro_torch.launch.serve import cut_depth
    counters = chip_smoke.kernel_counters()
    cfg = configs.get("paligemma_3b")
    want = chip_smoke.train_launches_wanted(cfg, 12, counters)
    assert want["flash_attention"] == want["flash_attention_bwd"] == 0
    assert want["gather_rows"] == want["embedding_grad_scatter"] == 12
    assert sum(want.values()) == 24
    layers = chip_smoke.F32_LAYERS["paligemma_3b"]
    assert layers == 2
    one = chip_smoke.train_launches_wanted(cut_depth(cfg, layers), 1,
                                           counters, 128,
                                           image_prefix=False)
    assert one["flash_attention"] == 2
    assert one["flash_attention_bwd"] == 2 * 3
    assert one["gather_rows"] == one["embedding_grad_scatter"] == 1
    assert ("paligemma_3b", 2, 128, False) in chip_smoke.F32_TRAINS
    # the image prefix changes only a VLM's count
    qwen = configs.get("qwen1_5_0_5b")
    assert chip_smoke.train_launches_wanted(qwen, 2, counters) == \
        chip_smoke.train_launches_wanted(qwen, 2, counters,
                                         image_prefix=False)


def test_b5_cases_hold_every_head_dim_of_the_forward():
    """``B5_CASES`` hold every head dim K5 takes; the d 256 and d 112
    cases are paligemma-3b's text-only training attention (8 x 512, its
    8 query heads of 256, causal) and kimi-k2's at published width (2 x
    512, 64 heads of 112, causal), each beside a ragged case (200 over
    300, no mask)."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention as k5
    cases = {c[0]: c[1:] for c in chip_smoke.B5_CASES}
    assert {c[4] for c in cases.values()} == set(k5.HEAD_DIMS)
    pali = configs.get("paligemma_3b")
    kimi = configs.get("kimi_k2_1t_a32b")
    assert cases["paligemma_text"] == (8, 512, 512, pali.n_heads,
                                       pali.d_head, True)
    assert cases["kimi"] == (2, 512, 512, kimi.n_heads, kimi.d_head, True)
    for d in (256, 112):
        assert cases[f"ragged_d{d}"] == (2, 200, 300, 4, d, False)


def test_train_run_without_a_resume_trains_once(monkeypatch, capsys):
    """A ``TRAIN_RUNS`` entry whose interval and kill step are None
    (paligemma-3b's: its 37.4 GiB state) trains once, with its launch
    counts and losses checked, and writes, kills and resumes nothing;
    every other entry keeps the kill and resume."""
    from repro_torch import configs
    from repro_torch.ft.manager import RunSupervisor
    from repro_torch.kernels.mars_gather import mars_gather as mg
    from repro_torch.launch import train
    entry = [r for r in chip_smoke.TRAIN_RUNS if r[0] == "paligemma_3b"]
    assert entry == [("paligemma_3b", 12, None, None,
                      ("--frontend", "stub"))]
    assert all(r[2] and r[3] for r in chip_smoke.TRAIN_RUNS
               if r[0] != "paligemma_3b")
    calls = []

    def fake_run(argv):
        calls.append(list(argv))
        steps = int(argv[argv.index("--steps") + 1])
        mg.gather_rows.launches += steps
        mg.scatter_add_rows.launches += steps
        return dict(cfg=configs.get("paligemma_3b"),
                    losses=[12.0 - i for i in range(steps)],
                    step_s=[0.5] * steps, start_step=0)
    monkeypatch.setattr(train, "run", fake_run)
    monkeypatch.setattr(RunSupervisor, "after_step", None)
    cuda = types.SimpleNamespace(
        reset_peak_memory_stats=lambda: None, synchronize=lambda: None,
        max_memory_allocated=lambda: 60 * 2 ** 30, empty_cache=lambda: None,
        memory_allocated=lambda: 0, memory_reserved=lambda: 0)
    rec, launches = chip_smoke.train_run(types.SimpleNamespace(cuda=cuda),
                                         *entry[0][:4], entry[0][4])
    assert len(calls) == 1 and "--resume" not in calls[0]
    assert calls[0][calls[0].index("--ckpt-interval") + 1] == "12"
    assert rec["step_ms"] == 500.0 and rec["peak_bytes"] == 60 * 2 ** 30
    assert "resume_rel" not in rec
    assert launches["gather_rows"] == launches["embedding_grad_scatter"] \
        == 12
    assert "no kill and resume" in capsys.readouterr().out


@pytest.mark.parametrize("arch,layers,moe", [("arctic_480b", 2, 2),
                                             ("kimi_k2_1t_a32b", 3, 2)])
def test_moe_smoke_launches_wanted_per_step(arch, layers, moe):
    """The MoE smoke configs a step: K5 once a layer (d 16) and B5 three
    times as often, K4 three times per MoE layer (kimi's first layer is
    dense) and B4 three times as often (bf16: the prologue's work order,
    dx and dw), no K2 or B2 (their 128 x 64 tables are below the
    kernel's 2**22 elements), no K3; a float32 config's B4 runs on CUDA
    cores, two launches a call."""
    from repro_torch import configs
    counters = chip_smoke.kernel_counters()
    want = chip_smoke.train_launches_wanted(configs.get_smoke(arch), 4,
                                            counters)
    assert want["flash_attention"] == 4 * layers
    assert want["flash_attention_bwd"] == 4 * layers * 3
    assert want["grouped_matmul"] == 4 * 3 * moe
    assert want["grouped_matmul_bwd"] == 4 * 3 * 3 * moe
    f32 = chip_smoke.train_launches_wanted(dataclasses.replace(
        configs.get_smoke(arch), compute_dtype="float32"), 4, counters)
    assert f32["grouped_matmul_bwd"] == 4 * 3 * 2 * moe
    assert want["gather_rows"] == want["embedding_grad_scatter"] == 0
    assert want["ssd_scan"] == want["ssd_scan_bwd"] == 0
    assert any(a == arch and "--smoke" in f
               for a, _, _, _, f in chip_smoke.TRAIN_RUNS)


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


def test_train_refusals_need_no_card(monkeypatch):
    """``launch.train`` refuses on CUDA, before it builds anything, the
    configs whose training state exceeds the card (80 GB here, whatever
    card there is): the full-width MoE, starcoder2, phi3 and deepseek
    configs."""
    from repro_torch.launch import train
    monkeypatch.setattr(train, "card_memory", lambda device: 80 * 10 ** 9)
    assert chip_smoke.train_refusals() == list(chip_smoke.TRAIN_REFUSED)
    assert chip_smoke.TRAIN_REFUSED == (
        "arctic_480b", "kimi_k2_1t_a32b", "starcoder2_7b",
        "phi3_medium_14b", "deepseek_coder_33b")


def test_train_refusals_print_bytes_per_device(monkeypatch, capsys):
    """Each refusal names the state's bytes per device under the trainer's
    mesh of one (``train_state_bytes`` there, the whole state) and the
    mesh; a config that fits is not among them."""
    from repro_torch import configs
    from repro_torch.launch import train
    monkeypatch.setattr(train, "card_memory", lambda device: 80 * 10 ** 9)
    chip_smoke.train_refusals()
    out = capsys.readouterr().out
    mesh = train.pick_mesh(1)
    for arch in chip_smoke.TRAIN_REFUSED:
        need = train.train_state_bytes(configs.get(arch), mesh=mesh)
        assert need > 80 * 10 ** 9
        assert f"takes {need} bytes" in out and \
            "per device on the mesh data 1 x model 1" in out, arch
    assert train.train_state_bytes(configs.get("qwen1_5_0_5b"),
                                   mesh=mesh) < 80 * 10 ** 9


def test_moe_sharded_case_is_arctics_column():
    """``MOE_SHARDED``'s column: 64 of arctic-480b's 128 experts (13.4 GB
    of bf16 weights), 8 x 512 tokens top-2 = 8192 assignments, and at 2
    columns a capacity of all of them (``column_capacity``: twice the even
    share), so no row can drop; K4 three launches a column, B4 three
    calls of ``bwd_launches``."""
    from repro_torch import configs
    arch, B, S = chip_smoke.MOE_LAYER
    c = chip_smoke.moe_sharded_case(configs.get(arch), B, S,
                                    chip_smoke.MOE_COLUMNS)
    assert (arch, chip_smoke.MOE_COLUMNS) == ("arctic_480b", 2)
    assert c == dict(experts=64, assignments=8192, capacity=8192,
                     weight_bytes=3 * 64 * 7168 * 4864 * 2)
    assert chip_smoke.moe_sharded_launches(torch.bfloat16) == \
        {"grouped_matmul": 3, "grouped_matmul_bwd": 9}
    assert chip_smoke.moe_sharded_launches(torch.float32) == \
        {"grouped_matmul": 3, "grouped_matmul_bwd": 6}


def test_moe_sharded_errors_hold_every_expert(monkeypatch):
    """``moe_sharded_errors`` holds column 0's y, dx and router gradient
    and every column's experts against the one-process layer (expert e
    of column r is the reference's r * E_loc + e): equal tensors give 0
    and bitwise; a change in one expert of column 1 beyond ``B4_TOL``
    shows in that weight alone."""
    gen = torch.Generator().manual_seed(0)
    E_loc, cols = 3, 2
    ref = {k: torch.randn(*s, generator=gen).to(torch.bfloat16)
           for k, s in (("y", (4, 8)), ("x", (4, 8)), ("router", (8, 6)),
                        ("w_in", (6, 8, 5)), ("w_gate", (6, 8, 5)),
                        ("w_out", (6, 5, 8)))}
    got = {r: {k: (v[r * E_loc:(r + 1) * E_loc] if k.startswith("w_")
                   else v).clone() for k, v in ref.items()}
           for r in range(cols)}
    errs = chip_smoke.moe_sharded_errors(torch, got, ref, E_loc)
    assert all(v[0] == 0.0 for v in errs.values())
    assert all(errs[w][2] for w in ("w_in", "w_gate", "w_out"))
    got[1]["w_out"][2, 0, 0] += 1.0
    errs = chip_smoke.moe_sharded_errors(torch, got, ref, E_loc)
    assert errs["w_out"][1] > 1.0 and not errs["w_out"][2]
    assert errs["w_in"][1] == 0.0 and errs["w_in"][2]


def test_train_kernel_rows_list_the_backward_kernels():
    """Three rows, flash_attention_bwd (B5), embedding_grad_scatter (B2)
    and ssd_scan_bwd (B3), with every key of the kernels line, their
    sources in the port, launches on a training run (qwen's; mamba2's
    for B3), and ``replaces`` naming the reference functions they take
    the place of: ``layers.sdpa`` and ``ssm.ssd_chunked`` (which the JAX
    trainer differentiates) and ``embedding_grad_scatter``."""
    t = dict(ms=1.0, plain_ms=2.0, bound_ms=0.1, bound_by="bytes",
             library_ms=0.5)
    record = {"b5_timing": {"qwen/bfloat16": t},
              "b2_timing": {"qwen/zipf/bfloat16": dict(t, library_ms=0.2)},
              "b2_cases": [dict(host_err=0.0), dict(host_err=0.0)],
              "b3_timing": {"mamba2_train/bfloat16": dict(
                  t, library_ms=None, bound_by="operations")},
              "b4_timing": {"arctic_w_in/bfloat16": dict(t, library_ms=0.7)}}
    counts = {k: 0 for k in chip_smoke.kernel_counters()}
    launches = {"train qwen1_5_0_5b": dict(
        counts, flash_attention_bwd=2160, embedding_grad_scatter=30),
        "train mamba2_370m": dict(counts, embedding_grad_scatter=12,
                                  ssd_scan_bwd=2304),
        "train arctic_480b": dict(counts, grouped_matmul=72,
                                  grouped_matmul_bwd=216),
        "qwen1_5_0_5b": counts}
    rows = chip_smoke.train_kernel_rows(launches, record, 3e-3, 2e-5, 4e-3)
    assert [r["name"] for r in rows] == ["flash_attention_bwd",
                                         "embedding_grad_scatter",
                                         "ssd_scan_bwd",
                                         "grouped_matmul_bwd"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    heads = ["def sdpa(", "def embedding_grad_scatter(", "def ssd_chunked(",
             "def _grouped_ffn("]
    for r, head in zip(rows, heads):
        assert keys <= set(r) and r["route"] == "cuda"
        assert (ROOT / r["source"]).is_file()
        path, line = r["replaces"].split(":")
        assert (ROOT / path).read_text().splitlines()[int(line) - 1] \
            .startswith(head)
    assert [r["launches"] for r in rows] == [2160, 30, 2304, 216]
    assert [r["max_abs_err"] for r in rows] == [3e-3, 0.0, 2e-5, 4e-3]
    assert [r["library_ms"] for r in rows] == [0.5, 0.2, None, 0.7]
    assert rows[0]["launches_by_path"] == {"train qwen1_5_0_5b": 2160,
                                           "train mamba2_370m": 0,
                                           "train arctic_480b": 0,
                                           "qwen1_5_0_5b": 0}
    assert rows[2]["launches_by_path"]["train mamba2_370m"] == 2304


def test_b3_bound_counts_the_code():
    """mamba2-370m's training scan (8 x 512, 32 heads of 64, state 128,
    8 chunks of 64): the products the code runs come to 9.30 GFLOP, on
    tensor cores in TF32 once a split pass (in bf16: 20.9 G, C B^T once,
    W^T dy and dy s three times, the rest twice), which bind at 495
    TFLOP/s beside the reverse pass's f32 update (0.043 ms against 0.042
    ms for its 141 MB); beside it the f32 CUDA-core bound of the same
    work (0.139 ms at 67 TFLOP/s); float32 inputs split every product in
    three; one chunk reads no entering state and runs no pass."""
    B, nc, H, q, P, N = 8, 8, 32, 64, 64, 128
    tri = q * (q + 1) // 2
    cb, dcb = B * nc * 2 * tri * N, B * nc * 4 * tri * N
    dw = a1 = B * nc * H * 2 * tri * P
    gx = B * nc * H * 4 * q * P * N                     # b G^T, x G
    u = sdy = B * (nc - 1) * H * 2 * q * P * N
    ew = B * (nc - 1) * H * 4 * P * N
    ops = cb + dcb + dw + a1 + gx + u + sdy + ew
    assert ops == 8 * 8 * (6 * tri * 128 + 32 * (4 * tri * 64
                                                + 4 * 64 * 64 * 128)) \
        + 8 * 7 * 32 * (4 * 64 * 64 * 128 + 4 * 64 * 128) == 9304539136
    b = chip_smoke.b3_bound(B, nc * q, H, P, N, q, "bfloat16", False)
    tensor = cb + 2 * dcb + 2 * dw + 3 * a1 + 2 * gx + 2 * u + 3 * sdy
    assert b["ops"] == ops and b["tensor_ops"] == tensor
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx((tensor / 495e12 + ew / 67e12)
                                          * 1e3)
    assert b["bound_f32_ms"] == pytest.approx(ops / 67e12 * 1e3)
    io = 2 * (2 * 8 * 512 * 32 * 64 + 2 * 2 * 8 * 512 * 128) \
        + 4 * (4 * 8 * 512 * 32 + 8 * 512 * 32 * 64 + 8 * 8 * 32 * 64 * 128
               + 8 * 8 * 32)
    assert b["bytes"] == io
    f = chip_smoke.b3_bound(B, nc * q, H, P, N, q, "float32", False)
    assert f["tensor_ops"] == 3 * (ops - ew) and f["ops"] == ops
    one = chip_smoke.b3_bound(1, 24, 50, 64, 16, 24, "bfloat16", True)
    assert one["bytes"] == 2 * (2 * 24 * 50 * 64 + 4 * 24 * 16) \
        + 4 * (4 * 24 * 50 + 24 * 50 * 64 + 50 * 64 * 16)
    tri = 24 * 25 // 2
    assert one["ops"] == 6 * tri * 16 + 50 * (4 * tri * 64 + 4 * 24 * 64 * 16)
    assert one["tensor_ops"] == 2 * tri * 16 + 2 * 4 * tri * 16 + 50 * (
        2 * 2 * tri * 64 + 3 * 2 * tri * 64 + 2 * 4 * 24 * 64 * 16)


def test_b3_err_adds_a_bf16_spacing_only_where_asked():
    want = torch.tensor([1.0, -3.0, 100.0])
    got = want + torch.tensor([0.0, 0.0, 0.25])
    err, use = chip_smoke.b3_err(got, want, False)
    assert err == 0.25 and use == pytest.approx(0.25 / (1e-4 * 100))
    err, use = chip_smoke.b3_err(got, want, True)
    assert use == pytest.approx(0.25 / (1e-2 + 0.5))


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
    (1, 100, 100, 2, 128, True), (1, 70, 70, 2, 256, True),
    (2, 33, 90, 2, 112, False)])
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
def test_kernels_with_a_gradient_launch_their_backward_on_the_card():
    """K4's wrapper on the card, for inputs that need a gradient, launches
    K4, then B4 (the prologue, dx and dw) on ``backward()``; K3's launches
    K3, then B3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3, B3, K4 and B4 run only there")
    from repro_torch.kernels.moe_dispatch import moe_dispatch as k4
    from repro_torch.kernels.ssd_scan import ssd_scan as k3
    assert chip_smoke.k4_grad_route(torch)["backward"] == [
        1, k4.bwd_launches(torch.bfloat16)]
    got = chip_smoke.k3_grad_route(torch)
    assert got["backward"] == [1, 2, k3.bwd_launches(2)]


# ---- B4's cases, bound and the MoE checks' helpers --------------------------

def test_b4_cases_are_the_published_expert_shapes():
    """B4's full-width cases are arctic-480b's and kimi-k2's published
    expert products at 8 x 512 training tokens; the smoke cases are the
    smoke configs'; the MoE layer check is arctic's."""
    from repro_torch import configs
    cases = {c[0]: c for c in chip_smoke.B4_CASES}
    arctic, kimi = configs.get("arctic_480b"), configs.get("kimi_k2_1t_a32b")
    smoke = configs.get_smoke("arctic_480b")
    T = 8 * 512
    for name, cfg, K, N in (("arctic_w_in", arctic, arctic.d_model,
                             arctic.d_expert),
                            ("arctic_w_out", arctic, arctic.d_expert,
                             arctic.d_model),
                            ("kimi_w_in", kimi, kimi.d_model, kimi.d_expert),
                            ("smoke_w_in", smoke, smoke.d_model,
                             smoke.d_expert),
                            ("smoke_w_out", smoke, smoke.d_expert,
                             smoke.d_model)):
        assert cases[name][2] == (T, cfg.top_k, cfg.n_experts, K, N)
    assert {c[1] for c in chip_smoke.B4_CASES} == {"route", "skew",
                                                   "skew_last", "empty",
                                                   "edge", "write_only"}
    assert cases["arctic_skew_last"][2] == cases["arctic_w_in"][2]
    assert cases["write_only"][2] == cases["arctic_w_in"][2]
    T, k, E = cases["rows_over_chunk"][2][:3]
    assert T * k / E > 256 and (T * k // E) % 256
    assert chip_smoke.MOE_LAYER == ("arctic_480b", 8, 512)
    assert ("arctic_480b", 2, 128, True) in chip_smoke.F32_TRAINS


@pytest.mark.parametrize("kind", ["route", "skew", "skew_last", "empty"])
def test_b4_case_routings(kind):
    """``b4_case`` on the host at a small size: rows sorted and padded as
    the model pads them; "skew" puts half the assignments on expert 0,
    "skew_last" on the last expert, "empty" leaves ``B4_EMPTY`` without a row; the incoming gradient is
    zero off the assignments' rows; ``offs`` ends each expert's padded
    segment, a multiple of 16 rows."""
    gen = torch.Generator("cpu").manual_seed(0)
    c = chip_smoke.b4_case(torch, gen, kind, (64, 2, 16, 32, 24),
                           torch.float32)
    sizes = c["sizes"]
    assert int(sizes.sum()) == c["A"] == 128
    assert int(c["n_used"]) * c["bm"] == c["live_rows"]
    if kind == "skew":
        assert int(sizes[0]) == 64
    if kind == "skew_last":
        assert int(sizes[-1]) == 64
    if kind == "empty":
        assert all(int(sizes[g]) == 0 for g in chip_smoke.B4_EMPTY)
    off = torch.ones(c["x"].shape[0], dtype=torch.bool)
    off[(c["dout"] != 0).any(1)] = False
    assert int((~off).sum()) == 128
    ends = c["offs"].tolist()
    assert ends[-1] == c["live_rows"] and all(e % 16 == 0 for e in ends)
    assert [b - a for a, b in zip([0] + ends, ends)] == [
        -(-int(n) // 16) * 16 for n in sizes]


def test_b4_write_only_case_has_no_live_row():
    """"write_only": the routing's operands with ``n_tiles`` 0, so no row
    is live, no expert is used, and the bound moves only the stores."""
    gen = torch.Generator("cpu").manual_seed(0)
    c = chip_smoke.b4_case(torch, gen, "write_only", (64, 2, 16, 32, 24),
                           torch.float32)
    assert int(c["n_used"]) == 0 and c["live_rows"] == 0 and c["A"] == 0
    assert c["used_groups"] == 0 and int(c["sizes"].sum()) == 0
    assert c["offs"].tolist() == [0] * 16
    M, K = c["x"].shape
    assert chip_smoke.b4_bound(c, "dx")["bytes"] == M * K * 4
    assert chip_smoke.b4_bound(c, "dw")["bytes"] == 16 * 32 * 24 * 4


def test_b4_bound_at_arctic_w_in():
    """arctic's w_in dw writes every expert's 7168 x 4864 bf16 matrix
    (8.93 GB: 2.66 ms at 3.35 TB/s) and its dx reads the used experts'
    as much; 0.57 TFLOP each take 0.58 ms: both bound by bytes."""
    M, K, N, G = 640 * 16, 7168, 4864, 128
    c = dict(x=torch.empty(M, K, dtype=torch.bfloat16, device="meta"),
             w=torch.empty(G, K, N, dtype=torch.bfloat16, device="meta"),
             live_rows=9600, used_groups=G, A=8192)
    dw = chip_smoke.b4_bound(c, "dw")
    dx = chip_smoke.b4_bound(c, "dx")
    assert dw["bytes"] == (9600 * (K + N) + G * K * N) * 2
    assert dx["bytes"] == (9600 * N + G * K * N + M * K) * 2
    assert dw["ops"] == dx["ops"] == 2 * 8192 * K * N
    assert dw["bound_by"] == dx["bound_by"] == "bytes"
    assert G * K * N * 2 / 3.35e12 * 1e3 == pytest.approx(2.66, abs=0.01)
    assert dw["bound_ms"] == pytest.approx(dw["bytes"] / 3.35e12 * 1e3)


@pytest.mark.parametrize("gap,ok", [(1e-7, True), (1e-3, False)])
def test_router_agreement_accepts_only_ties(gap, ok):
    """The float32 MoE step's router check: equal picks pass; a token
    whose picks differ passes only at a top-k gap below ``ROUTER_TIE``."""
    idx = torch.tensor([[0, 1], [2, 3], [4, 5]])
    gaps = torch.tensor([0.1, gap, 0.2])
    other = idx.clone()
    other[1] = torch.tensor([3, 6])
    same = chip_smoke.router_agreement(
        {"card": [(idx, gaps)], "host": [(idx.flip(1), gaps)],
         "float64": [(idx, gaps)]})
    assert same["ok"] and same["differ"] == 0
    got = chip_smoke.router_agreement(
        {"card": [(idx, gaps)], "host": [(other, gaps)],
         "float64": [(idx, gaps)]})
    assert got["ok"] == ok and got["differ"] == 1
    assert got["tie_gap"] == pytest.approx(gap)


def test_fingerprint_sees_one_bit():
    """The MoE layer check's bitwise fingerprint: equal for a copy, and
    different when one element moves by one bf16 spacing or one float32
    bit, at any position."""
    g = torch.Generator().manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.randn(4099, generator=g).to(dtype)
        assert chip_smoke.fingerprint(torch, a) == \
            chip_smoke.fingerprint(torch, a.clone())
        for i in (0, 2048, 4098):
            b = a.clone()
            b.view(torch.int16 if dtype == torch.bfloat16
                   else torch.int32)[i] += 1
            assert chip_smoke.fingerprint(torch, b) != \
                chip_smoke.fingerprint(torch, a)


@pytest.mark.parametrize("run", chip_smoke.TRAIN_RUNS, ids=lambda r: r[0])
def test_train_floor_is_the_model_flops_at_the_bf16_peak(run):
    from repro_torch import configs
    from repro_torch.launch import dryrun
    arch, *_, flags = run
    cfg = configs.get_smoke(arch) if "--smoke" in flags \
        else configs.get(arch)
    layers = chip_smoke.flag_value(flags, "--layers", 0)
    assert layers == {"hymba_1_5b": 17, "qwen1_5_0_5b": 12,
                      "mamba2_370m": 24}.get(arch, 0)
    if layers:
        cfg = serve.cut_depth(cfg, layers)
    if arch == "hymba_1_5b":
        assert [li for li in range(cfg.n_layers)
                if li % cfg.global_every == 0] == [0, 16]
    B, S = chip_smoke.TRAIN_TOKENS
    f = chip_smoke.train_floor(arch, flags)
    assert f["model_flops"] == 6.0 * cfg.n_active_params() * B * S
    assert f["floor_ms"] == f["model_flops"] / 989e12 * 1e3
    assert dryrun.PEAK_FLOPS == 989e12


def test_floor_check_refuses_a_step_below_the_floor():
    floor = chip_smoke.train_floor("qwen1_5_0_5b")["floor_ms"]
    assert chip_smoke.floor_check("qwen", 10 * floor, floor) == \
        pytest.approx(10.0)
    assert chip_smoke.floor_check("qwen", floor, floor) == 1.0
    for step in (0.99 * floor, 0.0, float("nan")):
        with pytest.raises(AssertionError, match="shorter than its"):
            chip_smoke.floor_check("qwen", step, floor)


def _bench_rows(**over):
    rows = {"moe_dispatch/mars_sorted": "run_len=128.0",
            "moe_dispatch/einsum_baseline": "run_len=1.02",
            "moe_dispatch/speedup": "0.12x",
            "mars_gather/plain": "page_run=1.24",
            "mars_gather/sorted": "page_run=10.0",
            "scheduler/fifo": "prefix_blocks_per_batch=16.00",
            "scheduler/mars": "prefix_blocks_per_batch=1.00",
            "mars_engine/reorder_8192req": "cycles=8192"}
    rows.update(over)
    return [{"name": k, "us_per_call": 1.0, "derived": v}
            for k, v in rows.items()]


def test_bench_rows_check_compares_the_statistics_only():
    got = chip_smoke.bench_rows_check(
        _bench_rows(**{"moe_dispatch/speedup": "3.50x"}), _bench_rows())
    assert len(got) == 7 and "moe_dispatch/speedup" not in got
    for name, bad in (("mars_engine/reorder_8192req", "cycles=8193"),
                      ("mars_gather/sorted", "page_run=9.9")):
        with pytest.raises(AssertionError, match="derived statistics"):
            chip_smoke.bench_rows_check(_bench_rows(**{name: bad}),
                                        _bench_rows())
    with pytest.raises(AssertionError):
        chip_smoke.bench_rows_check(_bench_rows()[:-1], _bench_rows())
    with pytest.raises(AssertionError):
        chip_smoke.bench_rows_check([], [])


def test_dryrun_cell_check_needs_an_ok_record():
    ok = {"status": "ok", "chips": 256}
    out = "a log line\n" + json.dumps(ok) + "\n#  mem={}\n"
    assert chip_smoke.dryrun_cell_check(out) == ok
    for rec in ({"status": "error", "error": "KeyError: x"},
                {"status": "planned"}, {"status": "skip"}):
        with pytest.raises(AssertionError, match="dry-run cell"):
            chip_smoke.dryrun_cell_check(json.dumps(rec))
    with pytest.raises(AssertionError):
        chip_smoke.dryrun_cell_check("")


def test_a_failing_dryrun_part_fails_the_run(monkeypatch):
    """``main`` with only the dryrun phase (on a stand-in card): the
    phase's failure comes out of ``main``, not a result line."""
    from repro_torch.kernels import build

    class _Failed(AssertionError):
        pass

    def failing(torch_, runs):
        assert runs == {}
        raise _Failed("a step below its floor")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    class _Gen:
        def manual_seed(self, seed):
            return self
    monkeypatch.setattr(torch, "Generator", lambda *a, **k: _Gen())
    monkeypatch.setattr(build, "build_all", lambda: {})
    monkeypatch.setattr(chip_smoke, "warm_profiler", lambda t: None)
    monkeypatch.setattr(chip_smoke, "dryrun_phase", failing)
    with pytest.raises(_Failed):
        chip_smoke.main(["--phases", "dryrun"])
