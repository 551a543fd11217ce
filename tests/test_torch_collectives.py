"""The port's collective accounting (``utils.collectives``, the
counterpart of ``repro/utils/hlo.py``): the reference's four
``tests/test_hlo_parser.py`` cases in the port's form (a collective in an
L-layer loop counts L times; output bytes by dtype and for a call with
several outputs; a single call counts 1; a step without collectives
gives ``{"total": 0}``), and the collectives the dry-run records on a
fake group of 4 against those of a real 4-process gloo run of the same
step on mesh (2, 2): kinds, counts and bytes, exactly."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.utils import collectives  # noqa: E402
from torch_procs import run_ranks  # noqa: E402

ARCHS = ("qwen1_5_0_5b", "arctic_480b")
B, S = 8, 16


def test_loop_body_collectives_counted_per_call():
    """An all-gather once and an all-reduce in a 10-layer loop: the
    reference's synthetic module (``test_hlo_parser.py``) as calls."""
    x = torch.zeros(128, 256)
    with dryrun.fake_group(2), collectives.record() as rec:
        out = torch.empty(256, 256)
        dist.all_gather_into_tensor(out, x)
        for _ in range(10):
            dist.all_reduce(x)
    res = collectives.collective_bytes(rec.calls)
    assert res["all-gather"] == 256 * 256 * 4
    assert res["all-gather_count"] == 1
    assert res["all-reduce"] == 128 * 256 * 4 * 10
    assert res["all-reduce_count"] == 10
    assert res["total"] == res["all-gather"] + res["all-reduce"]
    assert not dist.is_initialized()


def test_flat_tensors_is_in_order_and_leaves_no_cycle():
    """The tensors of a nest, in order; the call leaves nothing for the
    cycle collector (the dry-run's meter frees storages as their last
    reference goes)."""
    import gc
    a, b, c = torch.zeros(1), torch.zeros(2), torch.zeros(3)
    gc.collect()
    gc.disable()
    try:
        assert collectives.flat_tensors([a, (1, [b, None]), (c,)]) \
            == [a, b, c]
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_output_bytes_by_dtype_and_several_outputs():
    with dryrun.fake_group(2), collectives.record() as rec:
        dist.all_reduce(torch.zeros(4, 8, dtype=torch.bfloat16))
        dist.all_reduce(torch.zeros(2, 2))
        dist.all_reduce(torch.zeros(16, dtype=torch.int8))
        out = torch.empty(2, 16, dtype=torch.float8_e4m3fn)
        dist.all_gather_into_tensor(out, torch.empty(
            16, dtype=torch.float8_e4m3fn))
        parts = [torch.empty(3, 5) for _ in range(2)]
        dist.all_gather(parts, torch.zeros(3, 5))
        dist.all_reduce_coalesced([torch.zeros(2, 2), torch.zeros(4)])
    assert [c.bytes for c in rec.calls] == [64, 16, 16, 32, 2 * 3 * 5 * 4,
                                            16 + 16]
    assert [c.kind for c in rec.calls] == ["all-reduce"] * 3 + \
        ["all-gather"] * 2 + ["all-reduce"]


def test_single_call_counts_once_and_no_collectives_give_total_0():
    with dryrun.fake_group(4), collectives.record() as rec:
        out = torch.empty(4, 8)
        dist.reduce_scatter_tensor(torch.empty(1, 8), out)
    res = collectives.collective_bytes(rec.calls)
    assert res == {"reduce-scatter": 32, "reduce-scatter_count": 1,
                   "total": 32}
    with collectives.record() as rec:
        torch.ones(3) @ torch.ones(3)
    assert collectives.collective_bytes(rec.calls) == {"total": 0}


def _cfg(arch):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="float32",
                               compute_dtype="float32")


def _mesh22():
    return tmesh.Mesh(("data", "model"), {"data": 2, "model": 2}, ())


def _gloo_rank(rank, world, out):
    """A real step of each arch on the (2, 2) mesh of this gloo group
    under ``collectives.record``; rank 0 writes its calls."""
    from repro_torch.launch import train as ttrain
    from repro_torch.optim import adamw as optim
    from repro_torch.sharding import context as shctx
    from repro_torch.train import step as tstep
    mesh = tmesh.on_processes(_mesh22())
    got = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        oc = optim.OptConfig()
        with shctx.use_mesh(mesh):
            params = ttrain.init_params(cfg, torch.Generator().manual_seed(0),
                                        mesh)
            for p in params.parameters():
                p.requires_grad_(True)
            state = optim.opt_init(params, oc)
            tok = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(1))
            step = tstep.make_train_step(cfg, oc, tstep.TrainFlags(), mesh)
            with collectives.record() as rec:
                step(params, state, {"tokens": tok, "labels": tok})
        got[arch] = [dataclasses.astuple(c) for c in rec.calls]
    if rank == 0:
        with open(out, "w") as f:
            json.dump(got, f)


def test_fake_group_records_a_real_gloo_runs_collectives(tmp_path):
    """The step of qwen's and arctic's f32 smoke configs on mesh (2, 2):
    the dry-run's calls on a fake group of 4 (rank 0) equal rank 0's of
    4 gloo processes, call for call."""
    out = tmp_path / "calls.json"
    run_ranks(_gloo_rank, 4, tmp_path, str(out))
    real = json.loads(out.read_text())
    for arch in ARCHS:
        from repro_torch.optim import adamw as optim
        with dryrun.fake_group(4):
            traced = dryrun.trace_train(
                _cfg(arch), tmesh.on_processes(_mesh22(), "cpu"), B, S,
                opt_cfg=optim.OptConfig())
        fake = [list(dataclasses.astuple(c)) for c in traced["calls"]]
        assert fake == real[arch], arch
        res = collectives.collective_bytes(traced["calls"])
        assert res["all-gather_count"] > 0 and res["all-reduce_count"] > 0
