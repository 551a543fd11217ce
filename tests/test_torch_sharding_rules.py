"""The port's parameter sharding against the JAX package's: every
parameter's logical axes (``lm.param_specs`` against the reference's
``lm.init(cfg, key).specs``), the rules that map them to specs
(``spec_for``, ``param_shardings``, ``optim.state_shardings`` for AdamW
and Adafactor, ``batch_sharding``, ``cache_shardings``,
``sharded_bytes_per_device``) on meshes from one device to the
production pods (records here: a JAX mesh of repeated host devices, as
``tests/test_sharding_rules.py`` builds them), the part of each leaf a
mesh position holds (``rules.local_slices`` against JAX's
``devices_indices_map`` on 4 forced host devices), ``pick_mesh`` and
the per-device bytes ``launch.train.check_trainable`` refuses by."""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as joptim  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as toptim  # noqa: E402
from repro_torch.sharding import dtensor as tdtensor  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.all_archs()
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (16, 16), (2, 16, 16)]
IDS = ["x".join(map(str, m)) for m in MESHES]
KINDS = ("adamw", "adafactor")


def _meshes(shape):
    """The same mesh on both sides: a JAX mesh over repeated host devices
    and the port's record."""
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    n = math.prod(shape)
    jm = jax.sharding.Mesh(np.array(jax.devices() * n)[:n].reshape(shape),
                           axes)
    return jm, tmesh.Mesh(axes, dict(zip(axes, shape)), ())


def _cfgs(arch, smoke):
    return ((jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)) if smoke
            else (jconfigs.get(arch), tconfigs.get(arch)))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch, smoke):
    """The reference's abstract parameters, specs and optimizer states."""
    jc, _ = _cfgs(arch, smoke)
    cap = {}

    def mk(key):
        b = jlm.init(jc, key)
        cap["specs"] = b.specs
        return b.params
    params = jax.eval_shape(mk, jax.random.key(0))
    states = {kind: jax.eval_shape(
        lambda p, k=kind: joptim.opt_init(p, joptim.OptConfig(kind=k)),
        params) for kind in KINDS}
    return params, cap["specs"], states


@functools.lru_cache(maxsize=None)
def _port_tree(arch, smoke):
    """The port's parameters and optimizer states on the meta device."""
    _, tc = _cfgs(arch, smoke)
    params = ttrain.train_state(tc)["p"]
    states = {kind: toptim.opt_init(params, toptim.OptConfig(kind=kind))
              for kind in KINDS}
    return params, tlm.param_specs(tc), states


def _specs(tree):
    """A tree of NamedShardings as spec tuples (nested dicts)."""
    return jax.tree.map(lambda s: tuple(s.spec), tree,
                        is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, smoke):
    """``lm.param_specs`` is leaf for leaf the reference's specs tree:
    the same keys, the same tuples (``("layers",)`` first on a stacked
    leaf); and it lays out exactly ``lm.init``'s leaves."""
    _, jspecs, _ = _jax_tree(arch, smoke)
    params, tspecs, _ = _port_tree(arch, smoke)
    assert tspecs == jspecs
    tshapes = trules._map(lambda p, axes: len(axes) == p.dim(), params,
                          tspecs)
    assert all(jax.tree.leaves(tshapes))


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_param_shardings_match_the_reference(mesh):
    """``param_shardings`` of every config's full-width and smoke
    parameters: the reference's spec for every leaf, divisibility
    fallbacks included (heads to the head dim, vocab to embed, axes never
    used twice)."""
    jm, tm = _meshes(mesh)
    for arch in ARCHS:
        for smoke in (False, True):
            jparams, jspecs, _ = _jax_tree(arch, smoke)
            tparams, tspecs, _ = _port_tree(arch, smoke)
            want = _specs(jrules.param_shardings(jspecs, jparams, jm))
            assert trules.param_shardings(tspecs, tparams, tm) == want, \
                (arch, smoke)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_state_shardings_match_the_reference(mesh, kind):
    """``optim.state_shardings``: each moment and the master copy as its
    parameter, Adafactor's factored moments with the trailing axes
    dropped, the step and the (1,) placeholders replicated."""
    jm, tm = _meshes(mesh)
    for arch in ARCHS:
        jparams, jspecs, jstates = _jax_tree(arch, False)
        tparams, tspecs, tstates = _port_tree(arch, False)
        jp = jrules.param_shardings(jspecs, jparams, jm)
        tp = trules.param_shardings(tspecs, tparams, tm)
        want = joptim.state_shardings(jstates[kind], jp, jm)
        got = toptim.state_shardings(tstates[kind], tp, tm)
        assert type(got).__name__ == type(want).__name__
        for field in got._fields:
            assert getattr(got, field) == _specs(getattr(want, field)), \
                (arch, field)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_sharded_bytes_per_device_match_the_reference(mesh):
    """Per-device bytes of the parameters and of each optimizer state
    under their shardings: the reference's count (ceil per sharded
    dimension), for every config at full width."""
    jm, tm = _meshes(mesh)
    for arch in ARCHS:
        jparams, jspecs, jstates = _jax_tree(arch, False)
        tparams, tspecs, tstates = _port_tree(arch, False)
        jp = jrules.param_shardings(jspecs, jparams, jm)
        tp = trules.param_shardings(tspecs, tparams, tm)
        assert trules.sharded_bytes_per_device(tparams, tp, tm) == \
            jrules.sharded_bytes_per_device(jparams, jp, jm), arch
        for kind in KINDS:
            js = joptim.state_shardings(jstates[kind], jp, jm)
            ts = toptim.state_shardings(tstates[kind], tp, tm)
            assert trules.sharded_bytes_per_device(tstates[kind], ts, tm) \
                == jrules.sharded_bytes_per_device(jstates[kind], js, jm), \
                (arch, kind)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_batch_and_cache_shardings_match_the_reference(mesh):
    jm, tm = _meshes(mesh)
    for batch in (None, 1, 2, 3, 4, 6, 8, 32, 512, 1024):
        assert trules.batch_sharding(tm, batch) == \
            tuple(jrules.batch_sharding(jm, batch).spec), batch
    assert trules.replicated(tm) == tuple(jrules.replicated(jm).spec)
    for arch in ARCHS:
        jc, tc = _cfgs(arch, False)
        for batch in (1, 4, 32):
            want = jrules.cache_shardings(jm, jc, batch)
            got = trules.cache_shardings(tm, tc, batch)
            for field in ("k", "v", "ssm", "conv", "xk", "xv", "length"):
                w = getattr(want, field)
                assert getattr(got, field) == (None if w is None
                                               else tuple(w.spec)), \
                    (arch, batch, field)
        with pytest.raises(NotImplementedError, match="dense"):
            trules.cache_shardings(tm, tc, 4, backend="paged")


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("axes,shape,mesh", [
    (("embed", "heads", "head"), (7168, 56, 128), (1, 16)),
    (("embed", "kv_heads", "head"), (5120, 10, 128), (2, 16)),
    (("vocab", "embed"), (50280, 1024), (1, 16)),
    (("expert", "embed", "mlp"), (128, 7168, 4864), (2, 16)),
    (("layers", "ssm_heads"), (48, 24), (1, 16)),
    (("embed", "vocab"), (1024, 32001), (4, 2)),
    (("layers", "embed", "mlp"), (2, 6, 10), (2, 16, 16)),
])
def test_spec_for_matches_the_reference(axes, shape, mesh, fsdp):
    jm, tm = _meshes(mesh)
    want = jrules.spec_for(axes, shape, jrules.logical_rules(jm, fsdp), jm)
    assert trules.spec_for(axes, shape, trules.logical_rules(tm, fsdp),
                           tm) == tuple(want)
    assert trules.logical_rules(tm, fsdp) == jrules.logical_rules(jm, fsdp)


DEVICE_MAP = r"""
import json, sys
import numpy as np
import jax
from repro import configs
from repro.models import lm
from repro.sharding import rules
out = {}
for shape, axes in json.loads(sys.argv[1]):
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape), axes)
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    for arch in ("qwen1_5_0_5b", "arctic_480b", "hymba_1_5b"):
        cap = {}
        def mk(key):
            b = lm.init(configs.get_smoke(arch), key)
            cap["s"] = b.specs
            return b.params
        params = jax.eval_shape(mk, jax.random.key(0))
        shard = rules.param_shardings(cap["s"], params, mesh)
        for (path, sh), leaf in zip(
                jax.tree_util.tree_flatten_with_path(shard)[0],
                jax.tree.leaves(params)):
            name = "/".join(str(k.key) for k in path)
            got = {}
            for dev, idx in sh.devices_indices_map(leaf.shape).items():
                got[order[dev]] = [[s.indices(n)[0], s.indices(n)[1]]
                                   for s, n in zip(idx, leaf.shape)]
            out[f"{'x'.join(map(str, shape))}|{arch}|{name}"] = \
                [got[i] for i in range(len(order))]
print(json.dumps(out))
"""
LOCAL_MESHES = [((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
                ((4, 1), ("data", "model")),
                ((2, 1, 2), ("pod", "data", "model"))]


@pytest.fixture(scope="module")
def device_maps():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", DEVICE_MAP,
                           json.dumps(LOCAL_MESHES)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout)


@pytest.mark.parametrize("shape,axes", LOCAL_MESHES,
                         ids=["x".join(map(str, m[0])) for m in LOCAL_MESHES])
def test_local_slices_match_jax_device_index_maps(device_maps, shape, axes):
    """Each mesh position's part of every smoke parameter of qwen, arctic
    and hymba (``rules.local_slices`` of the port's spec, the part the
    sharded trainer's rank r draws and holds) is the index range JAX's
    ``devices_indices_map`` gives the device at that position."""
    from repro_torch.utils.tree import leaf_paths
    tm = tmesh.Mesh(axes, dict(zip(axes, shape)), ())
    tag = "x".join(map(str, shape))
    n = 0
    for arch in ("qwen1_5_0_5b", "arctic_480b", "hymba_1_5b"):
        params, specs, _ = _port_tree(arch, True)
        shard = trules.param_shardings(specs, params, tm)
        for name, p in leaf_paths(params):
            spec = functools.reduce(lambda t, k: t[k], name.split("/"),
                                    shard)
            got = [[list(r) for r in trules.local_slices(
                spec, tuple(p.shape), tm, trules.mesh_coords(tm, rank))]
                for rank in range(tm.size)]
            assert got == device_maps[f"{tag}|{arch}|{name}"], (arch, name)
            n += 1
    assert n == sum(1 for k in device_maps if k.startswith(tag + "|"))


def test_placements_follow_the_spec():
    """A spec entry is ``Shard`` of its tensor dimension on each mesh
    dimension it names (("pod", "data") on both, pod outermost), and
    ``Replicate`` elsewhere; entries out of the mesh's order refuse."""
    from torch.distributed.tensor import Replicate, Shard
    tm = tmesh.Mesh(("pod", "data", "model"),
                    {"pod": 2, "data": 2, "model": 2}, ())
    assert tdtensor.placements((("pod", "data"), None, "model"), tm) == \
        [Shard(0), Shard(0), Shard(2)]
    assert tdtensor.placements((None, "data"), tm) == \
        [Replicate(), Shard(1), Replicate()]
    assert tdtensor.placements((), tm) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        tdtensor.placements((("data", "pod"),), tm)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 128,
                               256, 300, 512, 1024])
def test_pick_mesh_is_the_references_rule(n):
    """``pick_mesh`` over n processes: the production meshes from 256 and
    512 (``make_production_mesh``), else the largest model axis of 16, 8,
    4, 2, 1 dividing n, as the reference's ``pick_mesh`` over n
    devices (``launch/train.py:32-45`` there)."""
    got = ttrain.pick_mesh(n)
    if n >= 512:
        want = {"pod": 2, "data": 16, "model": 16}
    elif n >= 256:
        want = {"data": 16, "model": 16}
    else:
        m = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
        want = {"data": n // m, "model": m}
    assert got.shape == want and got.axis_names == tuple(want)
    assert len(got.devices) == got.size == math.prod(want.values())
    if n == 1:                          # the one host device here
        jm = __import__("repro.launch.train", fromlist=["x"]).pick_mesh()
        assert dict(jm.shape) == got.shape


def test_production_meshes_are_the_references():
    for multi in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert m.shape == ({"pod": 2, "data": 16, "model": 16} if multi
                           else {"data": 16, "model": 16})
        assert m.axis_names == tuple(m.shape) and m.devices == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_bytes_per_device_match_the_reference(arch):
    """``train_state_bytes`` under a mesh is the reference's
    ``sharded_bytes_per_device`` of the parameters and their gradients
    (``param_shardings``) and the AdamW state (``state_shardings``); the
    mesh of one counts the whole state."""
    for shape in ((1, 1), (1, 4), (16, 16), (2, 16, 16)):
        jm, tm = _meshes(shape)
        jparams, jspecs, jstates = _jax_tree(arch, False)
        jp = jrules.param_shardings(jspecs, jparams, jm)
        js = joptim.state_shardings(jstates["adamw"], jp, jm)
        want = 2 * jrules.sharded_bytes_per_device(jparams, jp, jm) + \
            jrules.sharded_bytes_per_device(jstates["adamw"], js, jm)
        assert ttrain.train_state_bytes(tconfigs.get(arch), mesh=tm) == \
            want, shape
    assert ttrain.train_state_bytes(tconfigs.get(arch),
                                    mesh=ttrain.pick_mesh(1)) == \
        ttrain.train_state_bytes(tconfigs.get(arch))


CARD = 80 * 10**9


def test_check_trainable_counts_bytes_per_device(monkeypatch):
    """``check_trainable`` counts the state a device holds under the
    run's mesh: on the mesh of one it refuses arctic-480b and names its
    bytes and the mesh; on the production pod its share fits."""
    cfg = tconfigs.get("arctic_480b")
    monkeypatch.setattr(ttrain, "card_memory", lambda device: CARD)
    one = ttrain.train_state_bytes(cfg, mesh=ttrain.pick_mesh(1))
    with pytest.raises(ttrain.StateTooLarge,
                       match=f"{one} bytes .* per device on the mesh "
                             f"data 1 x model 1"):
        ttrain.check_trainable(cfg, "cuda")
    pod = tmesh.make_production_mesh(multi_pod=True)
    per = ttrain.train_state_bytes(cfg, mesh=pod)
    assert per < CARD < one
    ttrain.check_trainable(cfg, "cuda", mesh=pod)
