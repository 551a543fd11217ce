"""The ported slices as a whole: continuous-batching paged serving of the
qwen1.5-0.5b, hymba-1.5b, arctic-480b and kimi-k2 smoke configs through
both packages' ``ServeEngine(PagedLM)`` over ``PagedBackend(decode_mode="kernel")`` at
float32, with the same weights (the JAX init converted through
``repro_torch.convert``) and the same requests (a shared hot prefix,
forked samples, a pool tight enough to reject and evict; hymba's prompts
are multiples of its SSM chunk).  Served tokens and every stat must be
identical, step by step, on the pipelined and the synchronous decode
paths.  Then the port's own entry point end to end on the CPU, LM and
toy (the dense GQA smoke configs of starcoder2-7b, phi3-medium-14b and
deepseek-coder-33b exact in float32), and its ``--layers`` cut; and its
dense-backend entry point (no ``--paged``) against the JAX one: the same
served requests, batches and unique prefix blocks per batch, with and
without MARS; and ``--paged`` with ``--tiered-kv``, ``--shards 2`` and
both against the JAX ``main_paged`` (served count, steps, prefix hits,
evictions, shard defers and tier stats)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.kvcache.backend import PagedBackend as JPagedBackend  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tfa  # noqa: E402
from repro_torch.kernels.mars_gather import mars_gather as tmg  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_dispatch as tk4  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpa  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as tscan  # noqa: E402
from repro_torch.kvcache.backend import PagedBackend as TPagedBackend  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")


def _requests(mod, cfg):
    rng = np.random.default_rng(5)
    shared = tuple(int(t) for t in rng.integers(1, cfg.vocab, 16))
    out = []
    for i in range(7):
        # a hybrid model's prompts are whole SSM chunks (of 4: tails of
        # 4 or 12 leave the last block of 8 part-full, so forks copy it)
        n_tail = cfg.ssm_chunk * (1 + 2 * (i % 2)) if cfg.has_ssm \
            else 1 + i % 3
        tail = tuple(int(t) for t in rng.integers(1, cfg.vocab, n_tail))
        out.append(mod.Request(rid=i, prompt=shared + tail,
                               arrival=i * 1e-3, prefix_len=8,
                               max_new=3 + i % 3,
                               n_samples=2 if i in (1, 4) else 1))
    return out


def _engines(pipeline: bool, num_blocks: int = 26, arch="qwen1_5_0_5b"):
    kw = dict(F32, ssm_chunk=4) if arch == "hymba_1_5b" else F32
    jc = dataclasses.replace(jconfigs.get_smoke(arch), **kw)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), **kw)
    jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu")
    jb = JPagedBackend(jc, num_blocks=num_blocks, block_size=8,
                       decode_mode="kernel")
    tb = TPagedBackend(tc, num_blocks=num_blocks, block_size=8,
                       decode_mode="kernel", device="cpu")
    je = jengine.ServeEngine(jb.pool, jsched.MarsScheduler(pool=jb.pool),
                             jengine.PagedLM(jp, jc, jb), max_lanes=4,
                             pipeline=pipeline)
    te = tengine.ServeEngine(tb.pool, tsched.MarsScheduler(pool=tb.pool),
                             tengine.PagedLM(tp, tc, tb), max_lanes=4,
                             pipeline=pipeline)
    return (je, jb, _requests(jsched, jc)), (te, tb, _requests(tsched, tc))


def _drive(j, t):
    """``ServeEngine.run``'s loop on both engines in lockstep, comparing
    what each step made and what it staged to the device."""
    (je, jb, jreqs), (te, tb, treqs) = j, t
    for step in range(200):
        while jreqs:
            ok = je.submit(jreqs[0])
            assert te.submit(treqs[0]) == ok
            if not ok:
                break
            jreqs.pop(0)
            treqs.pop(0)
        assert len(te.scheduler) == len(je.scheduler)
        made = je.step(now=float(step))
        assert te.step(now=float(step)) == made
        assert tb.staged_blocks_last_step == jb.staged_blocks_last_step
        assert tb.inflight_steps == jb.inflight_steps
        assert [s.sid for s in te.running] == [s.sid for s in je.running]
        if not jreqs and not je.running and not len(je.scheduler):
            break
    else:
        raise AssertionError("engines did not drain")
    assert not treqs and not te.running


@pytest.mark.parametrize("arch,num_blocks", [("qwen1_5_0_5b", 26),
                                             ("hymba_1_5b", 26),
                                             ("arctic_480b", 26),
                                             ("kimi_k2_1t_a32b", 26)])
@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_matches_jax_engine(pipeline, arch, num_blocks):
    j, t = _engines(pipeline, num_blocks, arch)
    launches = (tpa.paged_attention.launches, tscan.ssd_scan.launches,
                tmg.gather_rows.launches, tk4.grouped_matmul.launches,
                tfa.flash_attention.launches)
    _drive(j, t)
    (je, jb, _), (te, tb, _) = j, t
    assert te.finished == je.finished
    assert sorted(te.finished) == list(range(7))
    assert [len(v) for _, v in sorted(te.finished.items())] == \
        [1, 2, 1, 1, 2, 1, 1]
    assert te.stats.as_dict() == je.stats.as_dict()
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()
    assert te.scheduler.stats.as_dict() == je.scheduler.stats.as_dict()
    assert tb._steps == jb._steps
    s = te.pool.stats
    assert s.prefix_hits and s.cow_copies          # shared prefix, forks
    assert te.scheduler.stats.pool_rejects > 0     # the pool was tight
    te.pool.check_invariants()
    assert te.pool.num_live == 0 and te.pool.reserved == 0
    # CPU tensors: the plain twins ran, no CUDA kernel launched
    assert (tpa.paged_attention.launches, tscan.ssd_scan.launches,
            tmg.gather_rows.launches, tk4.grouped_matmul.launches,
            tfa.flash_attention.launches) == launches


def test_serve_main_paged_smoke_cpu():
    out = tserve.main(["--paged", "--smoke", "--device", "cpu",
                       "--requests", "6", "--batch", "3", "--new-tokens",
                       "3", "--prefixes", "2", "--pool-blocks", "40",
                       "--parity-checks", "3"])
    assert out["served"] == 6 and out["parity_mismatches"] == 0
    assert out["parity_checked"] == 3 and out["decode"] == "kernel"
    assert out["decode_tokens"] == 6 * 3
    assert out["prefix_hits"] > 0
    for seqs in out["finished"].values():
        assert all(len(s) == 3 for s in seqs)


def test_serve_main_paged_hymba_smoke_cpu():
    """``--paged --config hymba_1_5b --smoke`` end to end on the CPU:
    served tokens pass the teacher-forced check against the dense
    backend, and the counts a chip run checks launches against add up."""
    out = tserve.main(["--paged", "--config", "hymba_1_5b", "--smoke",
                       "--device", "cpu", "--requests", "6", "--batch", "3",
                       "--new-tokens", "4", "--prefixes", "2",
                       "--pool-blocks", "40", "--parity-checks", "3"])
    assert out["served"] == 6 and out["parity_mismatches"] == 0
    assert out["parity_checked"] == 3 and out["decode"] == "kernel"
    assert out["decode_tokens"] == 6 * 4 and out["prefills"] == 6
    assert out["parity_decode_steps"] == 3 * (4 - 1)
    assert out["prefix_hits"] > 0
    for seqs in out["finished"].values():
        assert all(len(s) == 4 and all(0 <= t < 128 for t in s)
                   for s in seqs)


def test_serve_main_paged_hymba_float32_is_exact_cpu():
    """``--dtype float32`` serves in float32, where the teacher-forced
    check takes no margin: every served token is the dense argmax."""
    out = tserve.main(["--paged", "--config", "hymba_1_5b", "--smoke",
                       "--dtype", "float32", "--device", "cpu",
                       "--requests", "4", "--batch", "2", "--new-tokens",
                       "3", "--parity-checks", "4"])
    assert out["served"] == 4 and out["parity_mismatches"] == 0
    assert out["parity_max_deficit"] == 0.0


@pytest.mark.parametrize("arch,flags", [
    ("arctic_480b", []), ("arctic_480b", ["--no-kernel-decode"]),
    ("kimi_k2_1t_a32b", ["--layers", "2"])])
def test_serve_main_paged_moe_smoke_cpu(arch, flags):
    """``--paged --config <moe> --smoke`` end to end on the CPU in the
    config's bfloat16: served tokens pass the teacher-forced check, and
    the run reports the config it served (``--layers`` cuts kimi's 3
    layers to its dense layer and one routed layer)."""
    out = tserve.main(["--paged", "--config", arch, "--smoke", "--device",
                       "cpu", "--requests", "6", "--batch", "3",
                       "--new-tokens", "3", "--prefixes", "2",
                       "--pool-blocks", "40", "--parity-checks", "3",
                       *flags])
    assert out["served"] == 6 and out["parity_mismatches"] == 0
    assert out["decode_tokens"] == 6 * 3 and out["prefills"] == 6
    cfg = out["cfg"]
    assert cfg.is_moe and cfg.n_layers == (2 if flags[:1] == ["--layers"]
                                           else tconfigs.get_smoke(
                                               arch).n_layers)
    for seqs in out["finished"].values():
        assert all(len(s) == 3 and all(0 <= t < cfg.vocab for t in s)
                   for s in seqs)


@pytest.mark.parametrize("arch", ["starcoder2_7b", "phi3_medium_14b",
                                  "deepseek_coder_33b"])
def test_serve_main_paged_dense_gqa_float32_is_exact_cpu(arch):
    """``--paged --config <dense GQA model> --smoke --dtype float32`` end
    to end on the CPU, on the kernel and the gather decode paths: every
    request served, every served token the dense argmax, and both paths
    serve the same tokens."""
    outs = [tserve.main(["--paged", "--config", arch, "--smoke", "--dtype",
                         "float32", "--device", "cpu", "--requests", "6",
                         "--batch", "3", "--new-tokens", "3",
                         "--prefixes", "2", "--pool-blocks", "40",
                         "--parity-checks", "3", *flags])
            for flags in ([], ["--no-kernel-decode"])]
    for out in outs:
        assert out["served"] == 6 and out["parity_mismatches"] == 0
        assert out["parity_max_deficit"] == 0.0
        assert out["cfg"].name == tconfigs.get_smoke(arch).name
    assert outs[0]["finished"] == outs[1]["finished"]


@pytest.mark.parametrize("arch", ["arctic_480b", "kimi_k2_1t_a32b"])
def test_serve_main_paged_moe_float32_is_exact_cpu(arch):
    """The float32 gate of the MoE path: every served token is the dense
    argmax, on the kernel and on the gather decode path."""
    for flags in ([], ["--no-kernel-decode"]):
        out = tserve.main(["--paged", "--config", arch, "--smoke",
                           "--dtype", "float32", "--device", "cpu",
                           "--requests", "4", "--batch", "2",
                           "--new-tokens", "3", "--parity-checks", "4",
                           *flags])
        assert out["served"] == 4 and out["parity_mismatches"] == 0
        assert out["parity_max_deficit"] == 0.0


@pytest.mark.parametrize("arch,layers,ok", [
    ("arctic_480b", 2, True), ("arctic_480b", 35, True),
    ("arctic_480b", 36, False), ("arctic_480b", 0, False),
    ("kimi_k2_1t_a32b", 2, True), ("kimi_k2_1t_a32b", 1, False),
    ("kimi_k2_1t_a32b", 62, False), ("qwen1_5_0_5b", 25, False)])
def test_layers_cut(arch, layers, ok):
    """``--layers`` keeps the widths and cuts the depth; it refuses a depth
    above the config's and one at or below its leading dense layers."""
    cfg = tconfigs.get(arch)
    if ok:
        cut = tserve.cut_depth(cfg, layers)
        assert cut.n_layers == layers
        assert dataclasses.replace(cut, n_layers=cfg.n_layers) == cfg
    else:
        with pytest.raises(ValueError, match="--layers"):
            tserve.cut_depth(cfg, layers)


def test_layers_refused_by_the_entry_point():
    with pytest.raises(ValueError, match="--layers"):
        tserve.main(["--paged", "--config", "kimi_k2_1t_a32b", "--smoke",
                     "--device", "cpu", "--requests", "1", "--layers",
                     "1"])


def _check_inputs(dtype):
    from repro_torch.models import lm as tlm
    cfg = dataclasses.replace(tconfigs.get_smoke("arctic_480b"),
                              param_dtype=dtype, compute_dtype=dtype)
    params = tlm.init(cfg, torch.Generator("cpu").manual_seed(0))
    reqs = tserve.synth_requests(3, vocab=cfg.vocab, n_prefixes=2)
    rng = np.random.default_rng(0)
    served = [rng.integers(0, cfg.vocab, n).tolist() for n in (4, 4, 3)]
    return cfg, params, reqs, served


def test_dense_forced_logits_batch_matches_single_in_float32():
    """Teacher-forcing several sequences in one batch computes what each
    computes alone (float32), with the router gaps of every position."""
    cfg, params, reqs, served = _check_inputs("float32")
    prompts = [list(r.prompt) for r in reqs[:2]]
    both, gaps = tserve._dense_forced_logits(params, cfg, prompts,
                                             served[:2], "cpu")
    assert both.shape == (2, 4, cfg.vocab) and gaps.shape == (2, 4)
    assert (gaps >= 0).all()
    for b in range(2):
        one, g1 = tserve._dense_forced_logits(params, cfg, [prompts[b]],
                                              [served[b]], "cpu")
        np.testing.assert_allclose(both[b], one[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gaps[b], g1[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_noise(dtype):
    """The check's measured noise term: none in float32; in bfloat16 the
    per-position largest |logit| difference between each sequence alone
    and its length group in one batch (here two groups)."""
    cfg, params, reqs, served = _check_inputs(dtype)
    singles = [tserve._dense_forced_logits(params, cfg, [list(r.prompt)],
                                           [s], "cpu")[0][0]
               for r, s in zip(reqs, served)]
    noise, prefills, steps = tserve._dense_noise(params, cfg, reqs, served,
                                                 singles, "cpu")
    if dtype == "float32":
        assert (noise, prefills, steps) == (None, 0, 0)
        return
    assert prefills == 2 and steps == (4 - 1) + (3 - 1)
    assert [n.shape for n in noise] == [(4,), (4,), (3,)]
    assert all((n >= 0).all() and np.isfinite(n).all() for n in noise)
    # a group of one is its own batch: no noise
    assert (noise[2] == 0).all()


@pytest.mark.parametrize("top,dtype,want", [
    (4.7, torch.bfloat16, 16 * 2.0 ** -5),   # hymba's logit scale
    (3.0, torch.bfloat16, 16 * 2.0 ** -6),   # qwen's
    (1.0, torch.bfloat16, 16 * 2.0 ** -7),
    (0.1, torch.bfloat16, 5e-2),             # the floor
    (-9.0, torch.bfloat16, 16 * 2.0 ** -4),  # largest |logit|
    (4.7, torch.float32, 0.0)])
def test_near_tie_margin(top, dtype, want):
    """The teacher-forced check's margin: NEAR_TIE_SPACINGS spacings of
    the compute dtype at the position's largest |logit|, at least 5e-2;
    none in float32."""
    logits = np.zeros((2, 6))
    logits[:, 3] = top
    np.testing.assert_allclose(tserve.near_tie_margin(logits, dtype),
                               [want, want])


@pytest.mark.parametrize("flags", [["--no-kernel-decode"], ["--no-pipeline"],
                                   ["--classes", "3"]])
def test_serve_main_paged_variants_cpu(flags):
    base = ["--paged", "--smoke", "--device", "cpu", "--requests", "6",
            "--batch", "3", "--new-tokens", "2", "--parity-checks", "2"]
    ref = tserve.main(base)
    out = tserve.main(base + flags)
    assert out["served"] == 6 and out["parity_mismatches"] == 0
    if flags != ["--classes", "3"]:
        # gather vs kernel decode and pipelined vs synchronous serve the
        # same tokens
        assert out["finished"] == ref["finished"]


def test_serve_main_toy_matches_jax_toy():
    """``--paged --toy`` end to end, and its engine against the JAX
    package's toy engine on the same stream."""
    out = tserve.main(["--paged", "--toy", "--device", "cpu", "--requests",
                       "10", "--batch", "4", "--new-tokens", "4",
                       "--pool-blocks", "12"])
    assert out["served"] == 10 and out["pool_rejects"] > 0

    def run(mod, sched_mod, pool_mod, **kw):
        pool = pool_mod.BlockPool(pool_mod.PoolConfig(
            num_blocks=12, block_size=16, n_kv_heads=2, head_dim=64))
        eng = mod.ServeEngine(pool, sched_mod.MarsScheduler(pool=pool),
                              max_lanes=4, **kw)
        reqs = [sched_mod.Request(rid=r.rid, prompt=r.prompt,
                                  arrival=r.arrival,
                                  prefix_len=r.prefix_len, max_new=4)
                for r in tserve.synth_requests(10, vocab=128)]
        return eng.run(reqs), eng
    from repro.kvcache import pool as jpool
    from repro_torch.kvcache import pool as tpool
    jf, je = run(jengine, jsched, jpool, use_kernel=False)
    tf, te = run(tengine, tsched, tpool, use_kernel=True, device="cpu")
    assert tf == jf == out["finished"]
    assert te.stats.as_dict() == je.stats.as_dict()
    assert te.pool.stats.as_dict() == je.pool.stats.as_dict()


DENSE_ARGV = ["--smoke", "--requests", "16", "--batch", "8", "--new-tokens",
              "2"]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mamba2_370m",
                                  "paligemma_3b"])
def test_serve_main_dense_matches_jax_main(arch):
    """The dense-backend entry point: requests through the MARS scheduler
    (off, then on) into batches served by ``greedy_generate`` — the same
    served count, batches and unique prefix blocks per batch as the JAX
    ``main``, and MARS's page-coherence gain.  paligemma serves its
    text-only decoder, as the JAX ``main`` does: no batch carries an
    image prefix."""
    from repro.launch import serve as jserve
    want = jserve.main(["--arch", arch, *DENSE_ARGV])
    got = tserve.main(["--config", arch, "--device", "cpu", *DENSE_ARGV])
    for mars in (False, True):
        for key in ("served", "batches", "blocks_per_batch"):
            assert got[mars][key] == want[mars][key], (mars, key)
        assert got[mars]["mean_wait"] == pytest.approx(
            want[mars]["mean_wait"])
    assert got[True]["blocks_per_batch"] < got[False]["blocks_per_batch"]
    for mars in (False, True):
        for o in got[mars]["outputs"]:
            assert tuple(o["tokens"].shape) == (len(o["rids"]), 3)
            assert o["frontend"] is None


def test_serve_main_dense_whisper_serves_every_request():
    """whisper-base (encoder-decoder) serves every request through the
    port's dense entry point, each batch with its stub frame embeddings
    (normal * 0.02, (batch, frontend_seq, d_model)).  The JAX ``main``
    cannot run here: it calls ``greedy_generate`` without a frontend and
    fails in ``lm.py`` (``'NoneType' object has no attribute 'shape'``),
    a reference finding (ROADMAP.md §3)."""
    from repro.launch import serve as jserve
    with pytest.raises(AttributeError, match="shape"):
        jserve.main(["--arch", "whisper_base", *DENSE_ARGV])
    got = tserve.main(["--config", "whisper_base", "--device", "cpu",
                       *DENSE_ARGV])
    cfg = got["cfg"]
    assert cfg.family == "encdec"
    for mars in (False, True):
        assert got[mars]["served"] == 16 and got[mars]["batches"] == 2
        for o in got[mars]["outputs"]:
            B = len(o["rids"])
            assert tuple(o["frontend"].shape) == (B, cfg.frontend_seq,
                                                  cfg.d_model)
            assert abs(float(o["frontend"].float().std()) - 0.02) < 0.002
            toks = o["tokens"]
            assert tuple(toks.shape) == (B, 3)
            assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
    assert got[True]["blocks_per_batch"] < got[False]["blocks_per_batch"]


SPILL_ARGV = ["--paged", "--smoke", "--requests", "24", "--prefixes", "12",
              "--pool-blocks", "12", "--batch", "4", "--new-tokens", "3",
              "--parity-checks", "1"]


def _printed(text: str, key: str) -> str:
    """The value of ``key=`` on the JAX entry point's summary lines."""
    return text.split(f" {key}=", 1)[1].split()[0]


def _class_counts(text: str) -> list:
    """Each traffic class's admit/reject/defer/preempt/scheduled counts
    from an entry point's class lines."""
    return [line.split("class ", 1)[1].split(" wait")[0]
            for line in text.splitlines() if "] class " in line]


@pytest.mark.parametrize("flags", [["--tiered-kv"], ["--shards", "2"],
                                   ["--shards", "2", "--tiered-kv"],
                                   ["--shards", "2", "--tiered-kv",
                                    "--classes", "3"]])
def test_serve_main_paged_tiered_and_sharded_match_jax_main(flags, capsys,
                                                            monkeypatch):
    """``--paged --tiered-kv``, ``--shards 2`` and both on the CPU, against
    the JAX ``main_paged`` on the same stream (a pool too small for the
    12 hot prefixes, so blocks spill and come back): the same served
    count, engine steps, prefix hits, evictions, pool rejects, shard
    defers and tier stats, and the teacher-forced check passes.  With
    traffic classes, overload pauses batch-class decodes and resumes
    them through the shard routing: the same class counts, preemptions
    included."""
    from repro.launch import serve as jserve
    # the JAX entry point asks XLA for host devices through the
    # environment; keep that inside this test
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    capsys.readouterr()
    jserve.main(SPILL_ARGV + ["--arch", "qwen1_5_0_5b",
                              "--no-kernel-decode"] + flags)
    jax_out = capsys.readouterr().out
    got = tserve.main(SPILL_ARGV + ["--device", "cpu"] + flags)
    port_out = capsys.readouterr().out
    assert got["served"] == 24 and got["parity_mismatches"] == 0
    for key in ("served", "steps", "prefix_hits", "evictions"):
        assert str(got[key]) == _printed(jax_out, key), key
    assert _printed(port_out, "pool_rejects") == \
        _printed(jax_out, "pool_rejects")
    assert _class_counts(port_out) == _class_counts(jax_out)
    if "--classes" in flags:
        assert len(_class_counts(port_out)) == 3
        assert "preempt=0 " not in _class_counts(port_out)[1]
    if "--shards" in flags:
        assert str(got["shard_defers"]) == _printed(jax_out, "shard_defers")
        backend = got["backend"]
        assert backend.pool.n_shards == 2
        assert got["decode_steps"] == sum(b._steps
                                          for b in backend.backends)
        assert got["tier_probe"] == ("--tiered-kv" in flags)
    if "--tiered-kv" in flags:
        t = got["tiers"]
        for key in ("demotes", "promotes", "promoted_tokens", "clean_drops",
                    "drops"):
            assert str(t[key]) == _printed(jax_out, key), key
        assert f"{t['stall_us']:.1f}" == _printed(jax_out, "stall_us")
        assert t["demotes"] > 0 and t["promotes"] > 0
    else:
        assert got["tiers"] == {}
