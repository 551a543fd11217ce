"""The port's dry-run (``launch.dryrun``) against the JAX package's: the
shape cells and their applicability, ``lm.abstract_init`` and
``lm.abstract_cache`` against the reference's ``jax.eval_shape``, every
cell's planning numbers on the production meshes (parameters, optimizer
state or cache per chip, model flops, parameter counts, skips) against
the reference's ``abstract_state`` and ``rules`` on a JAX mesh of
repeated host devices; the traced flops under fake tensors against
``FlopCounterMode`` on a real CPU step, op for op; the serve cells
traced (a production decode cell, smoke prefill and decode cells on a
small fake mesh); the tensor-parallel train cell's cut flops; and one
full-width production train cell on 16 x 16 fake ranks in a process of
its own."""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.moe_dispatch import moe_dispatch as k4  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils import collectives  # noqa: E402
from repro_torch.utils.tree import leaf_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.all_archs()
MESHES = {False: (16, 16), True: (2, 16, 16)}


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored: the
    module appends a forced host device count to it at import."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdryrun


def _jax_mesh(multi_pod):
    shape = MESHES[multi_pod]
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices() * n)[:n].reshape(shape),
                             axes)


def test_shape_cells_match_the_reference():
    assert [dataclasses.astuple(s) for s in tconfig.SHAPES] == \
        [dataclasses.astuple(s) for s in jconfig.SHAPES]
    for s in jconfig.SHAPES:
        assert dataclasses.astuple(tconfig.shape_by_name(s.name)) == \
            dataclasses.astuple(s)
        for arch in ARCHS:
            assert tconfig.cell_applicable(tconfigs.get(arch), s) == \
                jconfig.cell_applicable(jconfigs.get(arch), s), (arch,
                                                                 s.name)
    with pytest.raises(KeyError):
        tconfig.shape_by_name("train_8k")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_the_reference(arch):
    """``lm.abstract_cache``: every field of the reference's
    ``jax.eval_shape`` cache, in shape and dtype, on the meta device."""
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    enc = jc.frontend_seq if jc.family == "encdec" else 0
    want = jlm.abstract_cache(jc, 128, 32768, enc_len=enc)
    got = tlm.abstract_cache(tc, 128, 32768, enc_len=enc)
    for field in ("k", "v", "ssm", "conv", "xk", "xv", "length"):
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        assert g.is_meta, field
        assert tuple(g.shape) == tuple(w.shape), field
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), field


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "whisper_base"])
def test_abstract_init_lays_out_the_parameters_on_meta(arch):
    """``lm.abstract_init``: the reference's ``abstract_init`` leaf for
    leaf in shape and dtype, on the meta device."""
    want = jax.tree_util.tree_flatten_with_path(
        jlm.abstract_init(jconfigs.get(arch)))[0]
    got = leaf_paths(tlm.abstract_init(tconfigs.get(arch)))
    assert len(got) == len(want)
    for (name, t), (path, w) in zip(got, want):
        assert t.is_meta, name
        assert name == "/".join(str(k.key) for k in path)
        assert tuple(t.shape) == tuple(w.shape), name
        assert str(t.dtype).removeprefix("torch.") == str(w.dtype), name


@functools.lru_cache(maxsize=None)
def _reference_state(arch, multi_pod, train):
    """The reference's ``abstract_state`` of a train cell (FSDP, with the
    optimizer ``opt_config_for`` picks) or of a serve cell (no FSDP, no
    optimizer) on the production mesh."""
    jdryrun = _reference_dryrun()
    jc = jconfigs.get(arch)
    if train:
        return jdryrun.abstract_state(jc, _jax_mesh(multi_pod), fsdp=True,
                                      with_opt=True,
                                      opt_cfg=jdryrun.opt_config_for(jc))
    return jdryrun.abstract_state(jc, _jax_mesh(multi_pod), fsdp=False,
                                  with_opt=False)


@functools.lru_cache(maxsize=None)
def _reference_plan(arch, shape, multi_pod):
    """The reference's planning numbers of a cell, as its ``run_cell``
    computes them before lowering; the cache also leaf by leaf."""
    jc = jconfigs.get(arch)
    cell = jconfig.shape_by_name(shape)
    ok, why = jconfig.cell_applicable(jc, cell)
    if not ok:
        return {"status": "skip", "reason": why}
    jm = _jax_mesh(multi_pod)
    chips = int(np.prod(list(jm.shape.values())))
    B, S = cell.global_batch, cell.seq_len
    out = {"chips": chips, "n_params": jc.n_params(),
           "n_active": jc.n_active_params()}
    if cell.kind == "train":
        params, pshard, opt, oshard = _reference_state(arch, multi_pod,
                                                       True)
        out["opt_gb_per_chip"] = round(
            jrules.sharded_bytes_per_device(opt, oshard, jm) / 1e9, 3)
        mf = 6.0 * jc.n_active_params() * B * S
    else:
        params, pshard, _, _ = _reference_state(arch, multi_pod, False)
        cache = jlm.abstract_cache(
            jc, B, S, enc_len=jc.frontend_seq if jc.family == "encdec"
            else 0)
        cshard = jrules.cache_shardings(jm, jc, B)
        out["cache_zipped"] = round(jrules.sharded_bytes_per_device(
            jax.tree.leaves(cache),
            jax.tree.leaves(cshard, is_leaf=lambda x: x is None),
            jm) / 1e9, 3)
        out["cache_gb_per_chip"] = round(sum(
            jrules.sharded_bytes_per_device([getattr(cache, f)],
                                            [getattr(cshard, f)], jm)
            for f in ("k", "v", "ssm", "conv", "xk", "xv", "length")
            if getattr(cache, f) is not None) / 1e9, 3)
        mf = 2.0 * jc.n_active_params() * B * (S if cell.kind == "prefill"
                                               else 1)
    out["params_gb_per_chip"] = round(
        jrules.sharded_bytes_per_device(params, pshard, jm) / 1e9, 3)
    out["model_flops_per_chip"] = mf / chips
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_planning_numbers_match_the_reference(arch, multi_pod):
    """Every shape of ``arch`` on the production mesh: the parameters and
    the optimizer state (train) or the cache (serve) per chip in GB with
    the reference's rounding, the model flops per chip, the parameter
    counts, and a skip's status and reason.  The serve cells' cache is
    the reference's rules leaf by leaf (its ``run_cell`` pairs leaves
    otherwise for the SSM and encoder-decoder families; see
    ``test_reference_cache_bytes_pair_leaves_out_of_order``)."""
    tm = tmesh.make_production_mesh(multi_pod=multi_pod)
    for cell in tconfig.SHAPES:
        want = dict(_reference_plan(arch, cell.name, multi_pod))
        if want.get("status") == "skip":
            got = dryrun.run_cell(arch, cell.name, multi_pod)
            assert (got["status"], got["reason"]) == ("skip",
                                                      want["reason"])
            continue
        want.pop("cache_zipped", None)
        got = dryrun.plan_cell(tconfigs.get(arch), cell, tm)
        if cell.kind == "train":
            # the port's own: the weights and gradients its step gathers
            assert got.pop("gathered_gb_per_chip") > \
                2 * got["params_gb_per_chip"]
        assert got == want, (arch, cell.name)


def test_reference_cache_bytes_pair_leaves_out_of_order():
    """The reference's ``run_cell`` (``dryrun.py:180-185`` there) zips the
    cache's leaves (None fields dropped) with its specs' (None kept), so
    for mamba2-370m and whisper-base it sizes the SSM state and the
    cross-attention K/V under other leaves' specs; the dense, MoE, hybrid
    and VLM families pair right.  The port sizes each field under its own
    spec."""
    for arch in ARCHS:
        want = _reference_plan(arch, "decode_32k", False)
        bad = arch in ("mamba2_370m", "whisper_base")
        assert (want["cache_zipped"] != want["cache_gb_per_chip"]) == bad, \
            arch
    m = _reference_plan("mamba2_370m", "decode_32k", False)
    assert (m["cache_zipped"], m["cache_gb_per_chip"]) == (6.527, 0.03)


def _f32_smoke(arch):
    return dataclasses.replace(tconfigs.get_smoke(arch),
                               param_dtype="float32",
                               compute_dtype="float32")


def _real_step_flops(cfg, B, S, remat=True):
    """FlopCounterMode's counts by op of one real step on the CPU, on the
    mesh of one."""
    from torch.utils.flop_counter import FlopCounterMode
    mesh = tmesh.make_local_mesh()
    params = tlm.init(cfg, torch.Generator().manual_seed(0))
    for p in params.parameters():
        p.requires_grad_(True)
    oc = toptim.OptConfig()
    state = toptim.opt_init(params, oc)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                        dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    step = tstep.make_train_step(cfg, oc, tstep.TrainFlags(remat=remat),
                                 mesh)
    with FlopCounterMode(display=False) as fc:
        _, _, metrics = step(params, state, batch)
    assert torch.isfinite(metrics["loss"])
    return {mod: {str(op): n for op, n in ops.items()}
            for mod, ops in fc.get_flop_counts().items()}


def _every_tile(tile_group, G, T, n_tiles):
    """``_live_tiles`` taking every row tile (groups clamped into [0, G)):
    the static bound the fake step stands for.  The tiles past the used
    ones hold zero rows, so the results do not change."""
    return [(i, min(max(g, 0), G - 1))
            for i, g in enumerate(tile_group.tolist())]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "arctic_480b"])
def test_traced_flops_equal_a_real_step_op_for_op(arch, monkeypatch):
    """The fake step's flops by op equal FlopCounterMode's on a real CPU
    step of the f32 smoke config on a mesh of one.  The fake MoE products
    run their static bound (every row tile), so for arctic the real step
    runs every tile too, and unpatched it counts no more."""
    cfg = _f32_smoke(arch)
    B, S = 4, 32
    traced = dryrun.trace_train(cfg, tmesh.make_local_mesh(), B, S,
                                opt_cfg=toptim.OptConfig(), remat=True,
                                flop_counts=True)
    assert traced["calls"] == []
    if cfg.is_moe:
        live = _real_step_flops(cfg, B, S)
        monkeypatch.setattr(k4, "_live_tiles", _every_tile)
        real = _real_step_flops(cfg, B, S)
        assert live["Global"]["aten.mm"] < real["Global"]["aten.mm"]
        assert {k: v for k, v in live["Global"].items() if k != "aten.mm"} \
            == {k: v for k, v in real["Global"].items() if k != "aten.mm"}
    else:
        real = _real_step_flops(cfg, B, S)
    assert traced["flop_counts"] == real
    assert traced["flops"] == sum(real["Global"].values())


def test_remat_and_memory_of_a_trace():
    """Remat recomputes each block's forward: more traced flops.  The
    temporaries' peak holds at least the float32 log-softmax over the
    vocabulary.  The arguments are the parameters, the optimizer state
    and the batch; the step updates them in place, so its outputs are
    those bytes less the batch, plus the metrics."""
    cfg = _f32_smoke("qwen1_5_0_5b")
    mesh = tmesh.make_local_mesh()
    on = dryrun.trace_train(cfg, mesh, 4, 32, opt_cfg=toptim.OptConfig())
    off = dryrun.trace_train(cfg, mesh, 4, 32, opt_cfg=toptim.OptConfig(),
                             remat=False)
    assert on["flops"] > off["flops"]
    for t in (on, off):
        assert t["memory"]["temp_size_in_bytes"] >= 4 * 32 * cfg.vocab * 4
    state = ttrain.train_state(cfg)
    params_opt = sum(t.numel() * t.element_size()
                     for _, t in leaf_paths({"p": state["p"],
                                             "o": state["o"]}))
    assert on["memory"]["argument_size_in_bytes"] == params_opt + 2 * 4 * 4 \
        * 32
    assert params_opt <= on["memory"]["output_size_in_bytes"] \
        <= params_opt + 64
    assert on["bytes"] > params_opt


def test_step_meter_counts_no_storage_a_cycle_keeps(monkeypatch):
    """``StepMeter`` frees a storage when its finalizer fires.  A storage
    kept only by a reference cycle would count as live until Python's
    cycle collector ran, so the peak would depend on when it ran.  With
    the collector off through arctic's smoke step on a fake group of 8
    (data 2 x model 4: the expert-parallel path), collecting afterwards
    frees nothing the meter counts."""
    import gc
    from torch._subclasses.fake_tensor import FakeTensorMode
    meters = []

    class Meter(dryrun.StepMeter):
        def __init__(self, known=()):
            super().__init__(known)
            meters.append(self)

    monkeypatch.setattr(dryrun, "StepMeter", Meter)
    FakeTensorMode()             # its first use imports modules
    mesh = tmesh.Mesh(("data", "model"), {"data": 2, "model": 4}, ())
    gc.collect()
    gc.disable()
    try:
        with dryrun.fake_group(mesh.size):
            traced = dryrun.trace_train(
                tconfigs.get_smoke("arctic_480b"),
                tmesh.on_processes(mesh, "cpu"), 8, 64)
        live = meters[0].live
        gc.collect()
    finally:
        gc.enable()
    assert meters[0].live == live
    assert traced["memory"]["temp_size_in_bytes"] == meters[0].peak > 0


def test_skipped_cells_record_why():
    """A cell the reference skips (full attention at 524k) records the
    reference's reason on either mesh."""
    for mp, mesh in ((False, "16x16"), (True, "2x16x16")):
        rec = dryrun.run_cell("qwen1_5_0_5b", "long_500k", mp)
        assert (rec["status"], rec["mesh"]) == ("skip", mesh)
        assert rec["reason"] == jconfig.cell_applicable(
            jconfigs.get("qwen1_5_0_5b"),
            jconfig.shape_by_name("long_500k"))[1]


def test_all_narrows_to_the_cells_named(tmp_path, capsys):
    """``--all`` with ``--arch`` and ``--shape`` runs that config's cells
    of that shape on both meshes (the way to split ``--all`` over
    processes), and ``--mesh`` narrows it to one."""
    out = tmp_path / "cells.jsonl"
    dryrun.main(["--all", "--arch", "qwen1_5_0_5b", "--shape",
                 "long_500k", "--out", str(out)])
    dryrun.main(["--all", "--arch", "whisper_base", "--shape",
                 "long_500k", "--mesh", "multi", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in recs] \
        == [("qwen1_5_0_5b", "long_500k", "16x16", "skip"),
            ("qwen1_5_0_5b", "long_500k", "2x16x16", "skip"),
            ("whisper_base", "long_500k", "2x16x16", "skip")]


def test_a_serve_cell_is_traced():
    """qwen1.5-0.5b's decode_32k cell on 16 x 16 fake ranks at full width
    is traced, not planned: status ok on the plain route, the train
    cell's fields (traced flops and bytes, collectives, the temporaries'
    peak and its ops) beside the parameters and cache per chip, the
    decode's model flops 2 N_active B, all-reduces over ``model`` (the
    row-parallel sums, the vocabulary put together)."""
    rec = dryrun.run_cell("qwen1_5_0_5b", "decode_32k", False)
    assert rec["status"] == "ok", rec.get("trace")
    assert (rec["route"], rec["chips"]) == ("plain", 256)
    cfg = tconfigs.get("qwen1_5_0_5b")
    assert rec["model_flops_per_chip"] == 2.0 * cfg.n_active_params() \
        * 128 / 256
    assert rec["collectives"]["all-reduce_count"] > 0
    assert rec["traced_flops_per_chip"] > 0 and rec["trace_s"] > 0
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] > 0 and mem["temp_peak_by_op"]
    # the arguments are this rank's parameters, its cache and the tokens
    assert mem["argument_size_in_bytes"] >= (rec["params_gb_per_chip"]
                                             + rec["cache_gb_per_chip"]) \
        * 1e9 * 0.999
    assert "reason" not in rec


def _serve_calls(arch, kind, shape, B=8, S=64):
    mesh = tmesh.Mesh(("data", "model"), dict(zip(("data", "model"),
                                                  shape)), ())
    with dryrun.fake_group(mesh.size):
        traced = dryrun.trace_serve(tconfigs.get_smoke(arch),
                                    tmesh.on_processes(mesh, "cpu"), kind,
                                    B, S)
    return traced, collectives.collective_bytes(traced["calls"])


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "paligemma_3b",
                                  "hymba_1_5b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_cells_trace_on_a_small_fake_mesh(arch, kind):
    """A smoke prefill and decode on a 2 x 4 fake mesh (qwen's cache cut
    by heads, paligemma's and hymba's by sequence) trace with all-reduces
    among their collectives; on 8 x 1, no model axis, none."""
    traced, coll = _serve_calls(arch, kind, (2, 4))
    assert traced["flops"] > 0 and traced["memory"]["temp_size_in_bytes"]
    assert coll["all-reduce_count"] > 0
    _, alone = _serve_calls(arch, kind, (8, 1))
    assert "all-reduce_count" not in alone


def test_tensor_parallel_train_cell_cuts_the_flops():
    """The f32 qwen smoke train cell on a 1 x 4 fake mesh traces at most
    0.3 of the flops of the same cell on a mesh of one: the model axis
    cuts the heads', the MLP's and the vocabulary's products."""
    cfg = _f32_smoke("qwen1_5_0_5b")
    one = dryrun.trace_train(cfg, tmesh.make_local_mesh(), 8, 64,
                             opt_cfg=toptim.OptConfig())
    mesh = tmesh.Mesh(("data", "model"), {"data": 1, "model": 4}, ())
    with dryrun.fake_group(4):
        four = dryrun.trace_train(cfg, tmesh.on_processes(mesh, "cpu"), 8,
                                  64, opt_cfg=toptim.OptConfig())
    assert four["flops"] <= 0.3 * one["flops"]


def test_production_train_cell_runs_in_a_process_of_its_own(tmp_path):
    """qwen1.5-0.5b's train_4k cell on 16 x 16 fake ranks at full width,
    through the CLI: status ok on the plain route, this rank's
    collectives recorded, within 60 s."""
    out = tmp_path / "cell.jsonl"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1_5_0_5b", "--shape", "train_4k", "--mesh", "single",
         "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("trace")
    assert wall < 60, wall
    assert (rec["route"], rec["chips"], rec["mesh"]) == ("plain", 256,
                                                         "16x16")
    assert rec["collectives"]["all-gather_count"] > 0
    assert rec["collectives"]["all-reduce_count"] > 0
    assert rec["traced_flops_per_chip"] > rec["model_flops_per_chip"]
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["temp_size_in_bytes"] > 0
