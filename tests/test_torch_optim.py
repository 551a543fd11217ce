"""Port parity for the optimizers: the port's AdamW and Adafactor
(``repro_torch.optim.adamw``, in place over torch trees) against the
reference's (pure jnp over the same trees) for three steps from the same
parameters and gradients — parameters, every state leaf, the gradient
norm and the learning rate — and the reference's own optimizer cases
(``tests/test_optim.py``) on the port.

Tolerance: float32 state and master 1e-6 (the same f32 formulas leaf by
leaf; only ``pow``, ``sqrt`` and ``rsqrt`` may round differently in the
last place); bfloat16 parameters must equal their own master rounded to
bf16 and lie within one bf16 spacing (2**-7 relative) of the
reference's."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as joptim  # noqa: E402
from repro_torch.optim import adamw as optim  # noqa: E402
from repro_torch.utils.tree import leaf_paths  # noqa: E402

torch.set_num_threads(1)

SHAPES = {"w": ((3, 130, 200), "float32"), "b": ((200,), "float32"),
          "emb": ((256, 128), "bfloat16"),
          "blk": {"x": ((4, 16), "bfloat16"), "s": ((), "float32")}}


def _tree(fn, spec=SHAPES, path=""):
    return {k: (_tree(fn, v, f"{path}/{k}") if isinstance(v, dict)
                else fn(f"{path}/{k}", *v)) for k, v in spec.items()}


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return _tree(lambda _p, shape, dt: (scale * rng.standard_normal(shape))
                 .astype(np.float32))


def _jax(tree, dtype_tree=SHAPES):
    return {k: (_jax(v, dtype_tree[k]) if isinstance(v, dict)
                else jnp.asarray(v, dtype_tree[k][1]))
            for k, v in tree.items()}


def _torch(tree, dtype_tree=SHAPES):
    return {k: (_torch(v, dtype_tree[k]) if isinstance(v, dict)
                else torch.tensor(v).to(getattr(torch, dtype_tree[k][1])))
            for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_three_steps_equal_the_reference(kind, clip):
    cfg = dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=5,
               grad_clip=clip, factored_min=128)
    p0 = _arrays(0)
    jp, tp = _jax(p0), _torch(p0)
    jst = joptim.opt_init(jp, joptim.OptConfig(**cfg))
    tst = optim.opt_init(tp, optim.OptConfig(**cfg))
    for step in range(3):
        g = _arrays(10 + step, scale=0.5)
        jp, jst, jm = joptim.opt_update(_jax(g), jst, jp,
                                        joptim.OptConfig(**cfg))
        tp, tst, tm = optim.opt_update(_torch(g), tst, tp,
                                       optim.OptConfig(**cfg))
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(tm[key]), _np(jm[key]),
                                       rtol=1e-6)
    assert int(tst.step) == int(jst.step) == 3
    assert tst.step.dtype == torch.int32
    jleaves = dict(leaf_paths(jst))
    for name, leaf in leaf_paths(tst):
        if name == ".step":
            continue
        want = jleaves[name]
        assert tuple(leaf.shape) == tuple(want.shape), name
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_allclose(_np(leaf), _np(want), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    jparams, masters = dict(leaf_paths(jp)), dict(leaf_paths(tst.master))
    for name, leaf in leaf_paths(tp):
        assert leaf.dtype == getattr(torch, str(jparams[name].dtype)), name
        assert torch.equal(leaf, masters[name].to(leaf.dtype)), name
        np.testing.assert_allclose(_np(leaf), _np(jparams[name]),
                                   rtol=2.0 ** -7, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("step", [0, 1, 5, 6, 50, 99, 100, 150])
def test_schedule_equals_the_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=6, total_steps=100)
    got = optim.schedule(optim.OptConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
    want = joptim.schedule(joptim.OptConfig(**cfg), jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---- the reference's cases (tests/test_optim.py) ---------------------------
def _quadratic_params():
    return {"w": torch.tensor([3.0, -2.0, 1.5]),
            "b": {"x": torch.tensor([[1.0, -1.0]], dtype=torch.bfloat16)}}


def _loss(p):
    return (torch.sum(p["w"] ** 2)
            + torch.sum(p["b"]["x"].float() ** 2))


def _grad(p):
    leaves = [p["w"], p["b"]["x"]]
    for t in leaves:
        t.requires_grad_(True)
    gw, gx = torch.autograd.grad(_loss(p), leaves)
    for t in leaves:
        t.requires_grad_(False)
    return {"w": gw, "b": {"x": gx}}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_converges(kind):
    cfg = optim.OptConfig(kind=kind, lr=0.1, weight_decay=0.0,
                          warmup_steps=1, total_steps=200)
    params = _quadratic_params()
    state = optim.opt_init(params, cfg)
    l0 = float(_loss(params))
    for _ in range(150):
        g = _grad(params)
        params, state, m = optim.opt_update(g, state, params, cfg)
    assert float(_loss(params)) < 0.05 * l0
    assert m["grad_norm"] >= 0


def test_adamw_bf16_params_keep_fp32_master():
    cfg = optim.OptConfig(kind="adamw", lr=0.05, weight_decay=0.0,
                          warmup_steps=1, total_steps=100)
    params = {"x": torch.full((4,), 1.0, dtype=torch.bfloat16)}
    state = optim.opt_init(params, cfg)
    assert state.master["x"].dtype == torch.float32
    # tiny updates must accumulate in the master copy, not vanish in bf16
    for _ in range(20):
        g = {"x": torch.full((4,), 1e-3)}
        params, state, _ = optim.opt_update(g, state, params, cfg)
    assert float((state.master["x"] - 1.0).abs().max()) > 0


def test_adafactor_factors_large_matrices():
    cfg = optim.OptConfig(kind="adafactor", factored_min=128)
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros((4, 8))}
    st = optim.opt_init(params, cfg)
    assert st.vr["big"].shape == (256,)
    assert st.vc["big"].shape == (512,)
    assert st.vr["small"].shape == (4, 8)     # unfactored
    assert st.vc["small"].shape == (1,)       # dummy
    # memory: factored state is tiny vs AdamW's 2 full moments
    fact = st.vr["big"].numel() + st.vc["big"].numel()
    assert fact < 256 * 512 // 64


def test_grad_clip_engages():
    cfg = optim.OptConfig(kind="adamw", lr=1e-3, grad_clip=1.0,
                          warmup_steps=1)
    params = {"x": torch.zeros((3,))}
    st = optim.opt_init(params, cfg)
    g = {"x": torch.tensor([100.0, 0.0, 0.0])}
    p1, _, m = optim.opt_update(g, st, params, cfg)
    assert float(m["grad_norm"]) == pytest.approx(100.0)
    # effective update bounded as if |g| == 1
    assert float(p1["x"].abs().max()) < 1e-2


def test_schedule_warmup_and_decay():
    cfg = optim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(optim.schedule(cfg, 1)) < float(optim.schedule(cfg, 10))
    assert float(optim.schedule(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(optim.schedule(cfg, 100)) < 0.2
    assert math.isfinite(float(optim.schedule(cfg, 10 ** 6)))
