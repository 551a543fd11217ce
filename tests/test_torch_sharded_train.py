"""The port's sharded training over gloo processes against its one-process
training: one float32 step of qwen's and arctic's smoke configs on
every mesh of 2 and 4 processes (``pick_mesh``'s model-parallel ones
and the data-parallel ones), and of hymba's, mamba2's, whisper's and
paligemma's on (1, 2) and (2, 2), tensor-parallel over ``model``, whose
loss, every gradient leaf and every
updated parameter must lie within 1e-5 of the one-process step's (of
the leaf's largest magnitude), each rank's initial shard bitwise the
slice of the one-process init; AdamW and Adafactor, one and two
microbatches.  Then ``launch.train`` on 2 processes: a kill-and-resume
exact to the resume tolerance, and its checkpoint files read by a
one-process run of the port and by the JAX package's ``restore``."""
import dataclasses
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.optim import adamw as joptim  # noqa: E402
from repro_torch.ft import checkpoint as tckpt  # noqa: E402
from repro_torch.ft.manager import RunSupervisor  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from torch_procs import run_ranks  # noqa: E402

REL = 1e-5
RESUME_RTOL = 1e-4          # chip_smoke.TRAIN_RESUME_RTOL, the reference's
# (config, mesh, microbatches, optimizer, the one-process step it equals):
# with the data axis above 1, arctic's expert-parallel layer averages its
# router losses over the data shards as the reference's does, which is
# the one-process step over as many microbatches
# the families TP cuts besides (hymba's heads and SSM heads, mamba2's
# SSM heads, whisper's encoder and cross-attention, paligemma's one KV
# head and image prefix) on the model rows of 2 and data x model 2 x 2
TP_FAMILIES = ("hymba_1_5b", "mamba2_370m", "whisper_base", "paligemma_3b")
JOBS = {2: [("qwen1_5_0_5b", (1, 2), 1, "adamw", 1),
            ("qwen1_5_0_5b", (2, 1), 1, "adamw", 1),
            ("qwen1_5_0_5b", (1, 2), 1, "adafactor", 1),
            ("arctic_480b", (1, 2), 1, "adamw", 1),
            ("arctic_480b", (2, 1), 1, "adamw", 1),
            ("arctic_480b", (1, 2), 2, "adamw", 2)]
        + [(a, (1, 2), 1, "adamw", 1) for a in TP_FAMILIES],
        4: [("qwen1_5_0_5b", (1, 4), 1, "adamw", 1),
            ("qwen1_5_0_5b", (2, 2), 1, "adamw", 1),
            ("qwen1_5_0_5b", (2, 2), 2, "adafactor", 2),
            ("arctic_480b", (1, 4), 1, "adamw", 1),
            ("arctic_480b", (2, 2), 1, "adamw", 2),
            ("arctic_480b", (4, 1), 1, "adafactor", 1)]
        + [(a, (2, 2), 1, "adamw", 1) for a in TP_FAMILIES]}
CASES = [(w, j) for w, jobs in JOBS.items() for j in jobs]
TRAIN_ARGV = ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "6",
              "--batch", "4", "--seq", "32", "--ckpt-interval", "2",
              "--log-every", "100", "--device", "cpu"]


class _Killed(Exception):
    pass


def _cfg(arch):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="float32",
                               compute_dtype="float32")


def _batch(cfg):
    """A global batch of 8 x 16 tokens, and an encoder-decoder or VLM
    model's stub frontend frames (numpy, seed 0)."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    b = next(TokenStream(DataConfig(vocab=cfg.vocab, seq_len=16,
                                    global_batch=8)))
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if cfg.frontend:
        fe = np.random.default_rng(0).standard_normal(
            (8, cfg.frontend_seq, cfg.d_model)) * 0.02
        out["frontend"] = torch.from_numpy(fe.astype(np.float32))
    return out


def _whole(tree):
    from repro_torch.sharding import dtensor
    from repro_torch.utils.tree import leaf_paths
    return {n: (t.full_tensor() if dtensor.is_dtensor(t) else t)
            .detach().clone() for n, t in leaf_paths(tree)}


def one_step(arch, shape, microbatches, kind):
    """One step of ``arch``'s smoke config in float32 from seed 0 on the
    mesh ``shape`` of this process group (None: the mesh of one): the
    global loss, and the whole initial parameters, gradients and updated
    parameters."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.optim import adamw as optim
    from repro_torch.sharding import context as shctx
    from repro_torch.train import step as tstep
    cfg = _cfg(arch)
    mesh = ttrain.pick_mesh(1) if shape is None else tmesh.on_processes(
        tmesh.Mesh(("data", "model"), dict(zip(("data", "model"), shape)),
                   ()))
    oc = optim.OptConfig(kind=kind, lr=1e-2, warmup_steps=1)
    seen, real = {}, optim.opt_update

    def spy(g, state, params, c):
        seen["grads"] = _whole(g)
        return real(g, state, params, c)
    with shctx.use_mesh(mesh):
        params = ttrain.init_params(cfg, torch.Generator().manual_seed(0),
                                    mesh)
        for t in params.parameters():
            t.requires_grad_(True)
        init = _whole(params)
        state = optim.opt_init(params, oc)
        step = tstep.make_train_step(
            cfg, oc, tstep.TrainFlags(remat=False,
                                      microbatches=microbatches), mesh)
        optim.opt_update = spy          # the step's gradients, as passed
        try:
            params, state, metrics = step(params, state, _batch(cfg))
        finally:
            optim.opt_update = real
    return dict(loss=float(metrics["loss"]), init=init,
                grads=seen["grads"], after=_whole(params))


def _rank(rank, world, out, jobs, workdir):
    """A rank of the session: every job's step, then (2 processes) the
    trainer's uninterrupted, killed and resumed runs."""
    import torch.distributed as dist
    res = {job: one_step(*job[:4]) for job in jobs}
    if rank == 0:
        torch.save(res, f"{out}/steps_{world}.pt")
    if world != 2:
        return
    argv = TRAIN_ARGV
    full = ttrain.main(argv + ["--workdir", f"{workdir}/full"])
    after_step = RunSupervisor.after_step

    def killing(self, step, dt):
        events = after_step(self, step, dt)
        if step == 3:
            raise _Killed
        return events
    RunSupervisor.after_step = killing
    try:
        ttrain.main(argv + ["--workdir", f"{workdir}/killed"])
        raise AssertionError("the killed run was not killed")
    except _Killed:
        pass
    finally:
        RunSupervisor.after_step = after_step
    if rank == 0:
        shutil.copytree(f"{workdir}/killed/ckpt", f"{workdir}/copy/ckpt")
    dist.barrier()
    resumed = ttrain.run(argv + ["--workdir", f"{workdir}/killed",
                                 "--resume"])
    if rank == 0:
        with open(f"{out}/train.json", "w") as f:
            json.dump(dict(full=full, resumed=resumed["losses"],
                           start=resumed["start_step"],
                           mesh=resumed["mesh"].shape), f)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train")
    for world, jobs in JOBS.items():
        run_ranks(_rank, world, out, str(out), jobs, str(out / "work"))
    steps = {}
    for world in JOBS:
        steps.update(torch.load(out / f"steps_{world}.pt"))
    return out, steps


_REF = {}


def _reference(arch, microbatches, kind):
    key = (arch, microbatches, kind)
    if key not in _REF:
        _REF[key] = one_step(arch, None, microbatches, kind)
    return _REF[key]


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= REL, f"{what}: {err:.3e} of its largest magnitude"


@pytest.mark.parametrize("world,job", CASES,
                         ids=[f"{j[0]}-{'x'.join(map(str, j[1]))}-mb{j[2]}-"
                              f"{j[3]}" for _, j in CASES])
def test_sharded_step_matches_one_process(session, world, job):
    _, steps = session
    arch, shape, mb, kind, ref_mb = job
    got, want = steps[job], _reference(arch, ref_mb, kind)
    for name, t in want["init"].items():
        assert torch.equal(got["init"][name], t), name   # bitwise slices
    assert abs(got["loss"] - want["loss"]) <= REL * abs(want["loss"])
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        _close(got["grads"][name], g, f"gradient {name}")
    # the sharded optimizer's update is the one-process update of the
    # same gradients (AdamW's first step is about lr * sign(g), which a
    # gradient near 0 flips, so the two steps' own updates are not held)
    from repro_torch.models import layers
    from repro_torch.optim import adamw as optim
    oc = optim.OptConfig(kind=kind, lr=1e-2, warmup_steps=1)
    params = layers.as_module(_nest(want["init"]))
    state = optim.opt_init(params, oc)
    optim.opt_update(_nest(got["grads"]), state, params, oc)
    for name, t in _whole(params).items():
        _close(got["after"][name], t, f"updated {name}")


def _nest(flat: dict) -> dict:
    out = {}
    for name, t in flat.items():
        *head, last = name.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t.clone()
    return out


def test_sharded_kill_and_resume_is_exact(session):
    """``launch.train`` over 2 processes (``pick_mesh``: data 1 x model
    2), killed after step 3 of 6, resumes from its checkpoint to the
    uninterrupted run's losses, which are the one-process run's."""
    out, _ = session
    rec = json.loads((out / "train.json").read_text())
    assert rec["mesh"] == {"data": 1, "model": 2} and rec["start"] == 3
    np.testing.assert_allclose(rec["resumed"], rec["full"][3:],
                               rtol=RESUME_RTOL)
    one = ttrain.main(TRAIN_ARGV + ["--workdir", str(out / "one")])
    np.testing.assert_allclose(rec["full"], one, rtol=RESUME_RTOL)


def test_sharded_checkpoint_resumes_in_one_process(session):
    """The sharded run's checkpoint (rank 0 wrote the gathered leaves) is
    the files a one-process run writes, and a one-process run resumes
    from it to the sharded run's losses."""
    out, _ = session
    rec = json.loads((out / "train.json").read_text())
    got = ttrain.run(TRAIN_ARGV + ["--workdir", str(out / "work/copy"),
                                   "--resume"])
    assert got["start_step"] == 3
    np.testing.assert_allclose(got["losses"], rec["resumed"],
                               rtol=RESUME_RTOL)
    ttrain.main(TRAIN_ARGV + ["--steps", "6", "--workdir",
                              str(out / "solo")])
    sharded = json.loads((out / "work/copy/ckpt/step_00000003/"
                          "manifest_0.json").read_text())
    solo = json.loads((out / "solo/ckpt/step_00000003/manifest_0.json")
                      .read_text())
    strip = lambda m: {n: (e["shape"], e["dtype"], [s["file"] for s in
                                                   e["shards"]])
                       for n, e in m["leaves"].items()}
    assert strip(sharded) == strip(solo)


def test_sharded_checkpoint_reads_in_the_jax_package(session):
    """The JAX package's ``restore`` reads the sharded run's float32
    leaves (the AdamW state) and step, equal to the port's reading."""
    out, _ = session
    directory = out / "work/copy/ckpt"
    cfg = ttrain.configs.get_smoke("qwen1_5_0_5b")
    state = ttrain.train_state(cfg)
    like_o = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                          dict(state["o"]._asdict()),
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    like_o["step"] = np.zeros((), np.int32)
    like = {"o": joptim.AdamWState(**like_o), "s": 0}
    want = jckpt.restore(like, 3, directory)
    port_like = {"o": ttrain.optim.opt_init(
        ttrain.lm.init(cfg, torch.Generator().manual_seed(0)),
        ttrain.optim.OptConfig()), "s": 0}
    got = tckpt.restore(port_like, 3, directory)
    assert int(want["s"]) == int(got["s"]) == 3
    assert int(want["o"].step) == int(got["o"].step) == 3
    from repro_torch.utils.tree import leaf_paths
    jl = dict(jax.tree_util.tree_flatten_with_path(want["o"].master)[0])
    n = 0
    for name, t in leaf_paths(got["o"].master):
        key = tuple(jax.tree_util.DictKey(k) for k in name.split("/"))
        np.testing.assert_array_equal(np.asarray(jl[key]), t.numpy())
        n += 1
    assert n == len(jl) > 0


# a tree whose leaves a sharded save gathers in pieces: the stacked
# leaf's first dimension is not cut, so it goes one layer (512 bytes) at
# a time; the embedding is cut on its first dimension and goes whole
# (1024 bytes, the largest piece); the tree gathers to 3616 bytes
_SAVE_TREE = {"stack": ((6, 8, 16), torch.float32, (None, None, "model")),
              "embed": ((64, 8), torch.bfloat16, ("model", None)),
              "norm": ((8,), torch.float32, (None,))}


def _save_rank(rank, world, out):
    """A rank's sharded save of ``_SAVE_TREE`` over a (1, 2) mesh, with
    the bytes of gathered pieces still alive recorded at every gather;
    rank 0 also saves the whole tree in one process."""
    import weakref
    from repro_torch.launch import mesh as tmesh
    from repro_torch.sharding import dtensor
    mesh = tmesh.on_processes(tmesh.Mesh(("data", "model"),
                                         {"data": 1, "model": 2}, ()))
    gen = torch.Generator().manual_seed(0)
    whole = {n: torch.randn(shape, generator=gen).to(dt)
             for n, (shape, dt, _) in _SAVE_TREE.items()}
    tree = {"p": {n: dtensor.distribute(dtensor.local_part(
        whole[n], spec, mesh), spec, mesh)
        for n, (_, _, spec) in _SAVE_TREE.items()},
        "o": {"step": torch.tensor(3, dtype=torch.int32)}, "s": 3}
    peak, refs, real = [0], [], tckpt._pieces

    def counted(leaf):
        for piece in real(leaf):
            if dtensor.is_dtensor(leaf):
                live = sum(r().nbytes for r in refs if r() is not None)
                peak[0] = max(peak[0], live + piece.nbytes)
                refs.append(weakref.ref(piece))
            yield piece
            del piece
    tckpt._pieces = counted
    try:
        tckpt.save(tree, 3, f"{out}/sharded")
    finally:
        tckpt._pieces = real
    with open(f"{out}/peak_{rank}.json", "w") as f:
        json.dump(dict(peak=peak[0], pieces=len(refs)), f)
    if rank == 0:
        tckpt.save({"p": whole, "o": tree["o"], "s": 3}, 3, f"{out}/solo")


def test_sharded_save_gathers_one_piece_at_a_time(tmp_path):
    """A sharded save holds at most one gathered piece on a rank at any
    gather, never the gathered tree: the stacked leaf goes one layer at
    a time, so the peak is the largest piece (1024 bytes), below the
    largest leaf (3072) and the tree (3616); and it writes the files a
    one-process save of the same tree writes, byte for byte."""
    run_ranks(_save_rank, 2, tmp_path, str(tmp_path))
    for rank in range(2):
        rec = json.loads((tmp_path / f"peak_{rank}.json").read_text())
        assert rec == {"peak": 1024, "pieces": 6 + 1 + 1}, (rank, rec)
    sharded = tmp_path / "sharded/step_00000003"
    solo = tmp_path / "solo/step_00000003"
    assert sorted(p.name for p in sharded.rglob("*")) == \
        sorted(p.name for p in solo.rglob("*"))
    for f in solo.rglob("*.*"):
        assert (sharded / f.relative_to(solo)).read_bytes() == \
            f.read_bytes(), f.name
