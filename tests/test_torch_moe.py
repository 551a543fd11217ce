"""Port parity for the MoE layer (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe`` at float32, with the same weights (the
JAX ``moe_init`` converted through ``repro_torch.convert``) and the same
numpy tokens: the router (indices wherever the k-th and (k+1)-th
probabilities differ by more than 1e-6, gates and aux losses at 1e-5),
the MARS dispatch, the einsum baseline and ``moe_apply`` with a shared
expert, at 1e-4 (the same float32 arithmetic summed in other orders).
Also the init's layout, scale and chunked draw, the analytic parameter
counts, and the runtime switch."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", compute_dtype="float32")
# the reference's dispatch-equivalence config, one with a shared expert,
# and the two MoE smoke configs
CFGS = {"eq": dict(name="eq", family="moe", n_layers=1, d_model=48,
                   n_heads=4, n_kv_heads=4, d_ff=64, vocab=64, n_experts=8,
                   top_k=2, d_expert=64, **F32),
        "shared": dict(name="sh", family="moe", n_layers=1, d_model=32,
                       n_heads=4, n_kv_heads=4, d_ff=48, vocab=64,
                       n_experts=6, top_k=3, d_expert=40,
                       n_shared_experts=1, act="gelu", **F32)}


def _cfgs(name):
    if name in CFGS:
        return JModelConfig(**CFGS[name]), ModelConfig(**CFGS[name])
    arch = {"arctic": "arctic_480b", "kimi": "kimi_k2_1t_a32b"}[name]
    return (dataclasses.replace(jconfigs.get_smoke(arch), **F32),
            dataclasses.replace(tconfigs.get_smoke(arch), **F32))


def _tree(tree):
    """numpy/JAX nested dict -> nested dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree))


_SETUP: dict = {}


def _setup(name):
    if name not in _SETUP:
        jc, tc = _cfgs(name)
        jp = jmoe.moe_init(jax.random.key(0), jc).params
        x = np.random.default_rng(1).standard_normal(
            (96, jc.d_model)).astype(np.float32)
        _SETUP[name] = (jc, tc, jp, _tree(jp), x)
    return _SETUP[name]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


NAMES = ["eq", "shared", "arctic", "kimi"]


@pytest.mark.parametrize("name", NAMES)
def test_router_topk_matches_jax(name):
    jc, tc, jp, tp, x = _setup(name)
    jidx, jg, jaux = jmoe.router_topk(jp, jnp.asarray(x), jc)
    tidx, tg, taux = tmoe.router_topk(tp, torch.from_numpy(x), tc)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1).numpy()
    top = np.sort(probs, -1)[:, ::-1]
    clear = top[:, jc.top_k - 1] - top[:, jc.top_k] > 1e-6
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tidx.numpy()[clear],
                                  np.asarray(jidx)[clear])
    _close(tg, jg, dict(atol=1e-5, rtol=1e-5))
    for k in ("moe_lb", "moe_z"):
        _close(taux[k], jaux[k], dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("name", NAMES)
def test_mars_dispatch_local_matches_jax(name):
    jc, tc, jp, tp, x = _setup(name)
    want, jaux = jmoe._mars_dispatch_local(jp, jnp.asarray(x), jc)
    got, taux = tmoe._mars_dispatch_local(tp, torch.from_numpy(x), tc)
    assert got.shape == (96, jc.d_model) and got.dtype == torch.float32
    _close(got, want)
    _close(taux["moe_lb"], jaux["moe_lb"], dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_einsum_matches_jax(name):
    jc, tc, jp, tp, x = _setup(name)
    want, _ = jmoe.moe_apply_einsum(jp, jnp.asarray(x), jc)
    got, _ = tmoe.moe_apply_einsum(tp, torch.from_numpy(x), tc)
    _close(got, want)


@pytest.mark.parametrize("dispatch", ["mars", "einsum"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_apply_matches_jax(name, dispatch):
    """(B, S, d) through the runtime's dispatch, plus the shared expert
    where configured (kimi and "shared")."""
    jc, tc, jp, tp, x = _setup(name)
    x3 = x.reshape(4, 24, -1)
    try:
        jmoe.set_dispatch(dispatch)
        tmoe.set_dispatch(dispatch)
        want, _ = jmoe.moe_apply(jp, jnp.asarray(x3), jc)
        got, _ = tmoe.moe_apply(tp, torch.from_numpy(x3), tc)
    finally:
        jmoe.set_dispatch("mars")
        tmoe.set_dispatch("mars")
    assert ("shared" in tp) == bool(tc.n_shared_experts)
    assert got.shape == x3.shape
    _close(got, want)


def test_set_dispatch_switches_and_refuses_unknown():
    tmoe.set_dispatch("einsum")
    assert tmoe._RUNTIME == tmoe.MoeRuntime("einsum")
    tmoe.set_dispatch("mars")
    with pytest.raises(ValueError):
        tmoe.set_dispatch("alltoall")
    assert tmoe._RUNTIME.dispatch == "mars"


def test_sharded_dispatch_waits_for_the_sharding_slice():
    """The expert-parallel dispatch runs over a mesh of processes only
    (``tests/test_torch_moe_sharded.py`` runs it): without one, or on a
    mesh record that spans none, it refuses rather than dispatching
    locally."""
    from repro_torch.launch import mesh as tmesh
    jc, tc, jp, tp, x = _setup("eq")
    record = tmesh.Mesh(("data", "model"), {"data": 1, "model": 2}, ())
    for mesh in (None, record):
        with pytest.raises(ValueError, match="mesh over processes"):
            tmoe._mars_dispatch_sharded(tp, torch.from_numpy(x), tc, mesh)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_init_layout_and_scale(name, dtype):
    """The port's ``moe_init`` has the reference's leaves, shapes and
    dtypes (a float32 router in any dtype) and its scale: normal over
    sqrt(shape[0]) — 1/sqrt(E) for the (E, d, e) expert weights."""
    jc, tc = _cfgs(name)
    jc, tc = (dataclasses.replace(c, param_dtype=dtype, compute_dtype=dtype)
              for c in (jc, tc))
    jtree = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(0),
                                                   jc).params)
    ttree = tmoe.moe_init(torch.Generator("cpu").manual_seed(0), tc)

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict)
                       else {pre + k: v})
        return out
    jf, tf = flat(jtree), flat(ttree)
    assert sorted(jf) == sorted(tf)
    for k, a in jf.items():
        assert tuple(tf[k].shape) == a.shape, k
        assert str(tf[k].dtype).split(".")[-1] == a.dtype.name, k
    assert tf["router"].dtype == torch.float32
    E = tc.n_experts
    for k in ("w_in", "w_gate", "w_out"):
        std = float(tf[k].float().std())
        assert abs(std * np.sqrt(E) - 1) < 0.1, (k, std)


def test_normal_draws_large_tensors_slice_by_slice(monkeypatch):
    """Above the chunk size ``_normal`` fills a preallocated tensor of the
    target dtype one leading slice (or block of rows) at a time, each
    draw no larger than the chunk; at or below it, one draw, as before."""
    sizes = []
    real = torch.randn

    def spy(*shape, **kw):
        out = real(*shape, **kw)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(tlayers, "_DRAW_ELEMS", 1000)
    monkeypatch.setattr(torch, "randn", spy)
    gen = torch.Generator("cpu").manual_seed(0)
    w = tlayers._normal(gen, (2, 3, 20, 30), torch.bfloat16, 0.5)
    assert w.dtype == torch.bfloat16 and w.shape == (2, 3, 20, 30)
    assert sizes == [600] * 6                      # one (20, 30) matrix each
    sizes.clear()
    e = tlayers._normal(gen, (100, 64), torch.float32, 1.0)
    assert sizes == [15 * 64] * 6 + [10 * 64]      # blocks of rows
    sizes.clear()
    small = tlayers._normal(torch.Generator("cpu").manual_seed(3), (10, 90),
                            torch.float32, 2.0)
    assert sizes == [900]
    monkeypatch.setattr(torch, "randn", real)
    want = torch.randn((10, 90), generator=torch.Generator("cpu")
                       .manual_seed(3)) * 2.0
    assert torch.equal(small, want)
    for t, scale in ((w, 0.5), (e, 1.0)):
        assert abs(float(t.float().std()) / scale - 1) < 0.1
    # every slice is a fresh draw
    assert not torch.equal(w[0, 0], w[0, 1]) and \
        not torch.equal(w[0, 0], w[1, 0])
    assert not torch.equal(e[:10], e[15:25])


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "hymba_1_5b",
                                  "arctic_480b", "kimi_k2_1t_a32b"])
def test_param_counts_match_reference(arch):
    for get in ("get", "get_smoke"):
        tc = getattr(tconfigs, get)(arch)
        jc = getattr(jconfigs, get)(arch)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()


@pytest.mark.parametrize("arch", ["arctic_480b", "kimi_k2_1t_a32b"])
def test_init_shapes_match_analytic_count(arch):
    """The port's init holds ``n_params`` parameters plus its norm scales
    (which the analytic count leaves out)."""
    from repro_torch.models import lm as tlm
    cfg = tconfigs.get_smoke(arch)
    p = tlm.init(cfg, torch.Generator("cpu").manual_seed(0))
    n = sum(t.numel() for t in p.parameters())
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert n == cfg.n_params() + norms
    full = tconfigs.get(arch)
    e = full.d_expert
    assert full.n_params() - full.n_active_params() == \
        (full.n_experts - full.top_k) * full.d_model * e * 3 * \
        (full.n_layers - full.n_dense_layers)
