"""Port parity for training: the port's ``lm.loss_fn`` and every
gradient leaf against ``jax.value_and_grad`` of the reference's for
every config's smoke variant in float32 (the same weights, the JAX init
converted; the same tokens; whisper and paligemma with the same
frontend), remat on and off; ``make_train_step`` for three steps against
the reference's, AdamW and Adafactor, one and two microbatches (loss,
parameters, optimizer state); ``launch.train.main`` against the
reference's ``main`` on the same argv (the port starting from the
reference's init); the reference's loss-decrease check for every arch
(``tests/test_arch_smoke.py:36``); and the CUDA refusals of
``launch.train.check_trainable``.

Tolerances (float32: the same arithmetic in another order and library):
the loss 1e-5 relative; each gradient leaf 1e-4 of its largest value
plus 1e-4 relative; after three optimizer steps the parameters and state
1e-4 of each leaf's largest value (Adam's first steps divide g by |g|,
which amplifies the gradients' last-place differences).  The trainer's
bf16 losses: 3e-4 relative (the frameworks round bf16 products at other
points; measured 6e-5)."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as toptim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.utils.tree import leaf_paths  # noqa: E402

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32")
ARCHS = tconfigs.all_archs()
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
TRAIN_RTOL = 3e-4


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


_PARAMS: dict = {}


def _params(arch, **kw):
    """(jax cfg, port cfg, jax params, numpy params) of a smoke variant,
    from one jitted JAX init (cached)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        jc, tc = _cfgs(arch, **kw)
        jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
        _PARAMS[key] = (jc, tc, jp, jax.tree.map(np.asarray, jp))
    return _PARAMS[key]


def _port_params(tc, np_params):
    params = convert.params_from_numpy(np_params, tc, "cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def _batch(cfg, B=2, S=16, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    fe = None
    if cfg.frontend:
        fe = (0.02 * rng.standard_normal(
            (B, cfg.frontend_seq, cfg.d_model))).astype(np.float32)
    return tokens[:, :-1], tokens[:, 1:], fe


def _leaf_close(name, got, want, atol_frac, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * max(scale, 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jc, tc, jp, npp = _params(arch, **F32)
    tokens, labels, fe = _batch(tc)
    labels = labels.copy()
    labels[0, :3] = -1                        # masked positions count 0

    def jloss(p):
        return jlm.loss_fn(p, jc, jnp.asarray(tokens), jnp.asarray(labels),
                           None if fe is None else jnp.asarray(fe))
    (jl, jaux), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    want = dict(leaf_paths(jg))
    for remat in (False, True):
        params = _port_params(tc, npp)
        names = leaf_paths(params)
        loss, aux = tlm.loss_fn(
            params, tc, torch.from_numpy(tokens), torch.from_numpy(labels),
            None if fe is None else torch.from_numpy(fe), remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in names])
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=LOSS_RTOL)
        for k in ("moe_lb", "moe_z"):
            np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                       rtol=LOSS_RTOL, atol=1e-7)
        assert {n for n, _ in names} == set(want)
        for (name, _), g in zip(names, grads):
            _leaf_close(f"{name} remat={remat}", g, want[name], GRAD_TOL,
                        GRAD_TOL)
        if remat:
            for a, b in zip(grads, first):
                assert torch.equal(a, b)
        first = grads


def _np_tree(tree):
    return {n: np.asarray(jnp.asarray(x, jnp.float32))
            for n, x in leaf_paths(tree)}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_matches_jax_for_three_steps(kind, microbatches):
    """phi3's smoke model in float32 (no attention biases: a key bias's
    gradient is zero up to rounding, and an optimizer step turns that
    noise into a full-size update of either sign)."""
    jc, tc, jp, npp = _params("phi3_medium_14b", **F32)
    ocfg = dict(kind=kind, lr=1e-3, warmup_steps=1, total_steps=10,
                factored_min=8)
    flags = dict(remat=False, microbatches=microbatches)
    jfn = jax.jit(jstep.make_train_step(jc, joptim.OptConfig(**ocfg),
                                        jstep.TrainFlags(**flags)))
    tfn = tstep.make_train_step(tc, toptim.OptConfig(**ocfg),
                                tstep.TrainFlags(**flags))
    jst = joptim.opt_init(jp, joptim.OptConfig(**ocfg))
    tp = _port_params(tc, npp)
    tst = toptim.opt_init(tp, toptim.OptConfig(**ocfg))
    for step in range(3):
        tokens, labels, _ = _batch(tc, B=4, seed=20 + step)
        jp, jst, jm = jfn(jp, jst, {"tokens": jnp.asarray(tokens),
                                    "labels": jnp.asarray(labels)})
        tp, tst, tm = tfn(tp, tst, {"tokens": torch.from_numpy(tokens),
                                    "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=GRAD_TOL)
    assert int(tst.step) == 3
    for got, want in ((tp, jp), (tst, jst)):
        w = _np_tree(want)
        for name, leaf in leaf_paths(got):
            if name != ".step":
                _leaf_close(name, leaf, w[name], STEP_TOL, STEP_TOL)


def test_train_step_splits_the_frontend_over_microbatches():
    """whisper's smoke model with two microbatches: each takes its rows
    of the frame embeddings, as the reference's scan does (loss after
    one AdamW step, float32)."""
    jc, tc, jp, npp = _params("whisper_base", **F32)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    flags = dict(remat=False, microbatches=2)
    tokens, labels, fe = _batch(tc, B=4, seed=3)
    jfn = jstep.make_train_step(jc, joptim.OptConfig(**ocfg),
                                jstep.TrainFlags(**flags))
    tfn = tstep.make_train_step(tc, toptim.OptConfig(**ocfg),
                                tstep.TrainFlags(**flags))
    _, _, jm = jfn(jp, joptim.opt_init(jp, joptim.OptConfig(**ocfg)),
                   {"tokens": jnp.asarray(tokens),
                    "labels": jnp.asarray(labels),
                    "frontend": jnp.asarray(fe)})
    tp = _port_params(tc, npp)
    _, _, tm = tfn(tp, toptim.opt_init(tp, toptim.OptConfig(**ocfg)),
                   {"tokens": torch.from_numpy(tokens),
                    "labels": torch.from_numpy(labels),
                    "frontend": torch.from_numpy(fe)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=GRAD_TOL)


def test_train_main_matches_the_reference(tmp_path, monkeypatch):
    """``launch.train.main --smoke --device cpu`` for qwen against the
    reference's ``main`` on the same argv (bf16), the port starting from
    the reference's init."""
    from repro.launch import train as jtrain
    argv = ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "6", "--batch",
            "2", "--seq", "32", "--ckpt-interval", "100", "--log-every",
            "100"]
    want = jtrain.main(argv + ["--workdir", str(tmp_path / "jax")])
    _, _, _, npp = _params("qwen1_5_0_5b")
    monkeypatch.setattr(tlm, "init", lambda cfg, gen:
                        convert.params_from_numpy(npp, cfg, gen.device))
    got = ttrain.main(argv + ["--workdir", str(tmp_path / "port"),
                              "--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)


# ---- the reference's loss-decrease check (tests/test_arch_smoke.py:36) -----
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss(arch):
    cfg = tconfigs.get_smoke(arch)
    params = tlm.init(cfg, torch.Generator().manual_seed(0))
    leaves = [p for _, p in leaf_paths(params)]
    for p in leaves:
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    fe = None
    if cfg.frontend:
        fe = torch.randn((2, cfg.frontend_seq, cfg.d_model),
                         generator=g) * 0.02

    def step():
        loss, _ = tlm.loss_fn(params, cfg, tokens, tokens, fe)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for w, gw in zip(leaves, grads):
                w.copy_(w.float() - 0.05 * gw.float())
        return float(loss)

    l0 = step()
    for _ in range(3):
        l1 = step()
    assert np.isfinite(l1)
    assert l1 < l0, (l0, l1)


# ---- CUDA refusals ---------------------------------------------------------
# the configs whose CUDA training forward would launch a kernel with no
# backward kernel: K3 (SSM layers), K4 (MoE layers)
NO_BACKWARD = {"hymba_1_5b", "mamba2_370m", "arctic_480b", "kimi_k2_1t_a32b"}


@pytest.mark.parametrize("arch", ARCHS)
def test_check_trainable_refuses_kernels_without_a_backward(arch):
    """``check_trainable`` refuses on CUDA, before anything is built,
    exactly the configs with SSM or MoE layers, at full width and in
    their smoke variants; the CPU trains all.  (K5 at a head dim outside
    B5's is refused by ``flash_attention`` itself, at its first call.)"""
    for cfg in (tconfigs.get(arch), tconfigs.get_smoke(arch)):
        ttrain.check_trainable(cfg, "cpu")
        if arch in NO_BACKWARD:
            with pytest.raises(NotImplementedError, match="K3|K4"):
                ttrain.check_trainable(cfg, "cuda")
        else:
            ttrain.check_trainable(cfg, "cuda")


@pytest.mark.parametrize("kernel", ["ssd_scan", "moe_dispatch"])
def test_kernels_without_a_backward_refuse_a_gradient(kernel):
    """K3's and K4's wrappers refuse, on CUDA, a call that autograd would
    differentiate (the kernels run outside the graph): ``_refuse_grad``
    raises when grad mode is on and an input needs a gradient, and lets
    a call under ``torch.no_grad()`` or with no such input through."""
    if kernel == "ssd_scan":
        from repro_torch.kernels.ssd_scan import ssd_scan as mod
    else:
        from repro_torch.kernels.moe_dispatch import moe_dispatch as mod
    a, b = torch.zeros(3), torch.zeros(3, requires_grad=True)
    mod._refuse_grad(a, a)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        mod._refuse_grad(a, b)
    with torch.no_grad():
        mod._refuse_grad(a, b)


def test_default_workdir_is_per_config_in_the_checkout(monkeypatch):
    """Without ``--workdir`` checkpoints go to the git-ignored
    ``build/train/<config name>`` of the checkout, so a smoke run and a
    full-width run, or two checkouts, never resume each other's."""
    seen = []

    class Built(Exception):
        pass

    def supervisor(workdir, **kw):
        seen.append(workdir)
        raise Built

    monkeypatch.setattr(ttrain, "RunSupervisor", supervisor)
    with pytest.raises(Built):
        ttrain.run(["--arch", "qwen1_5_0_5b", "--smoke", "--device", "cpu"])
    root = Path(ttrain.__file__).resolve().parents[3]
    assert Path(seen[0]) == root / "build" / "train" / \
        tconfigs.get_smoke("qwen1_5_0_5b").name
    assert tconfigs.get_smoke("qwen1_5_0_5b").name \
        != tconfigs.get("qwen1_5_0_5b").name


def test_zero_frontend_stalls_whisper_at_full_width():
    """A reference fault (ROADMAP.md §3) the port keeps in its default:
    the reference trainer's zero frames (``repro/launch/train.py:108``)
    put every whisper-base encoder LayerNorm at zero variance, so the
    gradient through the encoder overflows and the float32 global norm
    is inf in both packages (the clip then scales every update to 0);
    the stub frames of ``--frontend stub`` (normal * 0.02) give a finite
    norm in both.  Full width (the smoke config's two encoder layers do
    not overflow), one sequence of 8 tokens, the JAX init converted."""
    from repro.optim import adamw as jopt
    jc, tc = jconfigs.get("whisper_base"), tconfigs.get("whisper_base")
    jp = jax.jit(lambda k: jlm.init(jc, k).params)(jax.random.key(0))
    tp = _port_params(tc, jax.tree.map(np.asarray, jp))
    leaves = [p for _, p in leaf_paths(tp)]
    tokens = np.arange(5, 13, dtype=np.int32)[None]
    shape = (1, tc.frontend_seq, tc.d_model)
    stub = (0.02 * np.random.default_rng(0).standard_normal(shape)) \
        .astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda p, fe: jlm.loss_fn(
        p, jc, jnp.asarray(tokens), jnp.asarray(tokens),
        fe.astype(jc.cdtype))[0]))
    for fe, finite in ((np.zeros(shape, np.float32), False), (stub, True)):
        jnorm = float(jopt._global_norm(jgrad(jp, jnp.asarray(fe))))
        loss, _ = tlm.loss_fn(tp, tc, torch.from_numpy(tokens),
                              torch.from_numpy(tokens), torch.from_numpy(fe))
        tnorm = float(toptim._global_norm(torch.autograd.grad(loss, leaves)))
        assert np.isfinite(jnorm) == np.isfinite(tnorm) == finite, \
            (jnorm, tnorm)


def test_stub_frontend_trains_and_resumes_exactly(tmp_path):
    """``--frontend stub`` draws the frames from the step, so a run that
    resumes from a checkpoint reads the frames the uninterrupted run
    read: the same losses (whisper's smoke model, CPU, exact)."""
    argv = ["--arch", "whisper_base", "--smoke", "--steps", "5",
            "--batch", "2", "--seq", "16", "--ckpt-interval", "2",
            "--log-every", "100", "--device", "cpu", "--frontend", "stub"]
    full = ttrain.main(argv + ["--workdir", str(tmp_path / "a")])
    part = ttrain.run(argv[:4] + ["3"] + argv[5:]
                      + ["--workdir", str(tmp_path / "b")])
    assert part["losses"] == full[:3]
    resumed = ttrain.run(argv + ["--workdir", str(tmp_path / "b"),
                                 "--resume"])
    assert resumed["start_step"] == 3
    assert resumed["losses"] == full[3:]
    a = ttrain.batch_tensors(tconfigs.get_smoke("whisper_base"),
                             {"tokens": np.zeros((2, 4), np.int32)}, "cpu",
                             "stub", 7)["frontend"]
    assert float(a.float().std()) == pytest.approx(0.02, rel=0.1)
