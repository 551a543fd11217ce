"""The port's expert-parallel MoE dispatch (``models.moe._mars_dispatch_sharded``
over gloo processes) against the JAX package's (``shard_map`` over forced
host devices, in a subprocess): the same float32 weights and tokens, the
layer's output, its router losses and ``value_and_grad`` of
``sum(y * gy) + moe_lb + moe_z`` in the tokens, the router and the
expert weights, each within 1e-5 of its largest magnitude, and every
column's dropped rows equal to those the reference's capacity drops.
Meshes (data, model) of (1, 2), (1, 4) and (2, 2): with the data axis
split each rank routes its data row's tokens, its objective takes the
router losses over the data rows' count (as the trainer's step does),
and the gradients summed over the data rows are the reference's."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_procs import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T = 64                       # tokens of the window
REL = 1e-5
# (name, config, (data, model) mesh, router skew toward column 0's
# experts, REPRO_MOE_FULL): the skewed case routes more than a column's
# capacity C = ceil(2 A / 4) to column 0, which drops the rest, as the
# reference's does; under REPRO_MOE_FULL (C = A) nothing is dropped.
CASES = (("arctic_n2", "arctic_480b", (1, 2), 0.0, False),
         ("kimi_n2", "kimi_k2_1t_a32b", (1, 2), 0.0, False),
         ("arctic_n4_skew", "arctic_480b", (1, 4), 1.0, False),
         ("arctic_n4_skew_full", "arctic_480b", (1, 4), 1.0, True),
         ("arctic_d2_n2", "arctic_480b", (2, 2), 0.0, False),
         ("kimi_d2_n2", "kimi_k2_1t_a32b", (2, 2), 0.0, False))
LEAVES = ("router", "w_in", "w_gate", "w_out")

JAX_SIDE = r"""
import dataclasses, json, math, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import moe
cases, out, T = json.loads(sys.argv[1]), sys.argv[2], int(sys.argv[3])
for name, arch, (nd, n), skew, full in cases:
    if full:
        os.environ["REPRO_MOE_FULL"] = "1"
    else:
        os.environ.pop("REPRO_MOE_FULL", None)
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype="float32",
                              compute_dtype="float32")
    E, k = cfg.n_experts, cfg.top_k
    p = {n_: np.array(v) for n_, v in
         moe.moe_init(jax.random.key(0), cfg).params.items()
         if n_ in ("router", "w_in", "w_gate", "w_out")}
    p["router"][:, :E // n] += skew
    rng = np.random.default_rng(1)
    # with the skew, tokens of a positive mean lean to column 0's experts
    x = (rng.standard_normal((T, cfg.d_model)) + (0.5 if skew else 0.0)
         ).astype(np.float32)
    gy = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:nd * n]).reshape(nd, n), ("data", "model"))

    def f(p, x):
        y, aux = moe._mars_dispatch_sharded(p, x, cfg, mesh)
        return jnp.sum(y * gy) + aux["moe_lb"] + aux["moe_z"], (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    drops = []                        # (data row, column)
    for xd in np.split(x, nd):
        idx, _, _ = moe.router_topk(p, jnp.asarray(xd), cfg)
        counts = np.bincount(np.asarray(idx).reshape(-1) // (E // n),
                             minlength=n)
        A = len(xd) * k
        C = A if full else int(np.ceil(A / n * 2.0))
        drops.append(np.maximum(counts - C, 0))
    np.savez(f"{out}/{name}.npz", x=x, gy=gy, y=np.asarray(y),
             lb=np.asarray(aux["moe_lb"]), z=np.asarray(aux["moe_z"]),
             gx=np.asarray(gx), drops=drops,
             **{"p_" + n_: v for n_, v in p.items()},
             **{"g_" + n_: np.asarray(v) for n_, v in gp.items()})
"""


def _cfg(arch):
    from repro_torch import configs
    return dataclasses.replace(configs.get_smoke(arch),
                               param_dtype="float32",
                               compute_dtype="float32")


def _port_rank(rank, world, out, cases):
    """One rank: the port's dispatch on the reference's inputs (its data
    row's tokens, its column's experts); saves the whole of what the
    ranks computed (each leaf's gradient summed over the data rows, the
    experts' put together over the columns)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import moe as tmoe
    from repro_torch.sharding import context as shctx
    from repro_torch.sharding import dtensor
    for name, arch, (nd, n), skew, full in cases:
        if nd * n != world:
            continue
        mesh = tmesh.on_processes(tmesh.Mesh(
            ("data", "model"), {"data": nd, "model": n}, ()))
        here = dtensor.coords(mesh)
        row, col = here["data"], here["model"]
        if full:
            os.environ["REPRO_MOE_FULL"] = "1"
        else:
            os.environ.pop("REPRO_MOE_FULL", None)
        cfg = _cfg(arch)
        E_loc = cfg.n_experts // n
        ref = np.load(f"{out}/{name}.npz")
        p = {n_: torch.from_numpy(ref["p_" + n_]) for n_ in LEAVES}
        p = {n_: (t if n_ == "router" else t[col * E_loc:(col + 1) * E_loc]
                  ).clone().requires_grad_() for n_, t in p.items()}
        Tl = T // nd
        mine = slice(row * Tl, (row + 1) * Tl)
        x = torch.from_numpy(ref["x"][mine]).requires_grad_()
        gy = torch.from_numpy(ref["gy"][mine])
        tmoe.COLUMN_DROPS = []
        with shctx.use_mesh(mesh):
            y, aux = tmoe._mars_dispatch_sharded(p, x, cfg, mesh)
            routed = len(tmoe.COLUMN_DROPS)
            # moe_apply's routed part (without a shared expert's)
            y_apply, _ = tmoe.moe_apply(
                p, x.detach()[None],
                dataclasses.replace(cfg, n_shared_experts=0))
        routed = (routed, len(tmoe.COLUMN_DROPS))
        ((y * gy).sum() + (aux["moe_lb"] + aux["moe_z"]) / nd).backward()
        drops = torch.zeros(nd, n, dtype=torch.int64)
        drops[row, col] = tmoe.COLUMN_DROPS[0]
        tmoe.COLUMN_DROPS = None
        dist.all_reduce(drops)

        def rows(t):                  # the data rows' parts, in order
            parts = [torch.empty_like(t) for _ in range(nd)]
            dist.all_gather(parts, t.contiguous(),
                            group=mesh.dist.get_group("data"))
            return torch.cat(parts).numpy()
        gw = {}
        for n_ in LEAVES[1:]:
            g = dtensor.all_sum(p[n_].grad, mesh, ("data",))
            parts = [torch.empty_like(g) for _ in range(n)]
            dist.all_gather(parts, g, group=mesh.dist.get_group("model"))
            gw[n_] = torch.cat(parts).numpy()
        np.savez(f"{out}/{name}_rank{rank}.npz", y=rows(y.detach()),
                 y_apply=rows(y_apply[0].detach()),
                 lb=aux["moe_lb"].detach().numpy(),
                 z=aux["moe_z"].detach().numpy(), gx=rows(x.grad),
                 g_router=dtensor.all_sum(p["router"].grad, mesh,
                                          ("data",)).numpy(),
                 drops=drops.numpy(), routed=np.array(routed),
                 **{"g_" + n_: g for n_, g in gw.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_MOE_FULL", None)
    done = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, json.dumps(CASES), str(out),
         str(T)], env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    for world in (2, 4):
        run_ranks(_port_rank, world, out, str(out), CASES)
    return out


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= REL, f"{what}: {err:.3e} of its largest magnitude"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_dispatch_matches_the_reference(runs, case):
    name, arch, (nd, n) = case[:3]
    ref = np.load(runs / f"{name}.npz")
    ranks = [np.load(runs / f"{name}_rank{r}.npz") for r in range(nd * n)]
    got = ranks[0]
    for key in ("y", "lb", "z", "gx", "g_router", "g_w_in", "g_w_gate",
                "g_w_out"):
        _close(got[key], ref[key], f"{name} {key}")
    # every rank ends with the same output, token and router gradients
    for r in ranks[1:]:
        for key in ("y", "gx", "g_router", "lb", "z"):
            np.testing.assert_array_equal(r[key], got[key])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dropped_rows_equal_the_reference(runs, case):
    name, arch, n, skew, full = case
    ref = np.load(runs / f"{name}.npz")
    got = np.load(runs / f"{name}_rank0.npz")
    np.testing.assert_array_equal(got["drops"], ref["drops"])
    if skew and not full:
        assert ref["drops"][0, 0] > 0        # the case does drop rows
    if full:
        assert not ref["drops"].any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_takes_the_sharded_dispatch(runs, case):
    """Under a mesh whose model axis divides the experts, ``moe_apply``
    dispatches through ``_mars_dispatch_sharded`` (one more column call
    recorded) and returns its output (plus a shared expert's, left out
    here)."""
    name = case[0]
    got = np.load(runs / f"{name}_rank0.npz")
    assert tuple(got["routed"]) == (1, 2)
    np.testing.assert_array_equal(got["y_apply"], got["y"])


def test_expert_parallel_condition():
    from repro_torch.models import moe as tmoe
    cfg = _cfg("arctic_480b")                      # 8 experts
    rec = lambda m: type("M", (), {"shape": {"data": 1, "model": m}})()
    assert [tmoe.expert_parallel(cfg, rec(m)) for m in (1, 2, 3, 4, 8, 16)] \
        == [False, True, False, True, True, False]
    assert not tmoe.expert_parallel(cfg, None)


@pytest.mark.parametrize("n_model", [2, 3, 4, 16])
def test_column_capacity_is_the_reference_bound(n_model, monkeypatch):
    from repro_torch.models import moe as tmoe
    monkeypatch.delenv("REPRO_MOE_FULL", raising=False)
    for A in (1, 8, 128, 8192):
        assert tmoe.column_capacity(A, n_model) == \
            int(np.ceil(A / n_model * 2.0))
    monkeypatch.setenv("REPRO_MOE_FULL", "1")
    assert tmoe.column_capacity(100, n_model) == 100
