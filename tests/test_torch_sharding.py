"""The port's shard discovery against the JAX package's: the mesh
registry (``sharding.context``), the pool's shard count over a mesh
(``sharding.rules.pool_shard_count``, ``_axis_size``),
``kvcache.sharded_pool.discover_shards`` and the serving meshes
(``launch.mesh.make_serve_mesh`` / ``make_local_mesh``), for the same
shard counts.  Meshes of more devices than this host has are records
with the same ``axis_names`` and ``shape`` on both sides."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kvcache import sharded_pool as jsharded  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.sharding import context as jcontext  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.kvcache import sharded_pool as tsharded  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.sharding import context as tcontext  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402


def _record(shape: dict):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.mark.parametrize("shape", [
    None, {"data": 1, "model": 1}, {"data": 1, "model": 4},
    {"data": 2, "model": 8}, {"pod": 2, "data": 16, "model": 16},
    {"data": 4}])
def test_pool_shard_count_matches_reference(shape):
    mesh = None if shape is None else _record(shape)
    assert trules.pool_shard_count(mesh) == jrules.pool_shard_count(mesh)
    if mesh is not None:
        for axes in (tuple(shape), tuple(shape)[:1], tuple(shape)[-1]):
            assert trules._axis_size(mesh, axes) == \
                jrules._axis_size(mesh, axes)


@pytest.mark.parametrize("n_shards", [None, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("model", [None, 1, 4])
def test_discover_shards_matches_reference(n_shards, model):
    """Explicit counts win; otherwise the mesh's model axis, explicit or
    ambient; 1 without a mesh."""
    mesh = None if model is None else _record({"data": 1, "model": model})
    assert tsharded.discover_shards(n_shards, mesh) == \
        jsharded.discover_shards(n_shards, mesh)
    with tcontext.use_mesh(mesh), jcontext.use_mesh(mesh):
        assert tsharded.discover_shards(n_shards) == \
            jsharded.discover_shards(n_shards)


def test_use_mesh_nests_and_restores():
    a, b = _record({"data": 1, "model": 2}), _record({"data": 1, "model": 3})
    for ctx in (tcontext, jcontext):
        assert ctx.current_mesh() is None
        with ctx.use_mesh(a) as got:
            assert got is a and ctx.current_mesh() is a
            with ctx.use_mesh(b):
                assert ctx.current_mesh() is b
            assert ctx.current_mesh() is a
        assert ctx.current_mesh() is None
        with pytest.raises(KeyError):
            with ctx.use_mesh(a):
                raise KeyError("restored on the way out")
        assert ctx.current_mesh() is None


def test_data_and_model_axes_match_reference():
    for shape in ({"data": 1, "model": 2},
                  {"pod": 2, "data": 16, "model": 16}):
        mesh = _record(shape)
        assert tcontext.data_axes(mesh) == jcontext.data_axes(mesh)
        assert tcontext.model_axis(mesh) == jcontext.model_axis(mesh)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_make_serve_mesh_shrinks_to_the_devices_there_are(n_shards):
    """As the reference's ``make_serve_mesh`` on a host of one device:
    axes ("data", "model"), the model axis shrunk to the devices there
    are (one here), so the pool takes its shard count from the caller
    and the shards map onto the mesh's devices round robin."""
    want = jmesh.make_serve_mesh(n_shards)
    got = tmesh.make_serve_mesh(n_shards, device="cpu")
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert len(got.devices) == want.devices.size
    assert trules.pool_shard_count(got) == jrules.pool_shard_count(want)
    assert all(d == torch.device("cpu") for d in got.devices)
    devices = [got.devices[s % len(got.devices)] for s in range(n_shards)]
    assert devices == [torch.device("cpu")] * n_shards


def test_make_local_mesh_matches_reference():
    want, got = jmesh.make_local_mesh(), tmesh.make_local_mesh()
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert trules.pool_shard_count(got) == jrules.pool_shard_count(want) == 1


def test_make_serve_mesh_on_cuda_counts_the_cards(monkeypatch):
    """On CUDA the mesh's devices are the cards ``torch.cuda`` reports,
    the model axis the smaller of the shard count and the card count."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = tmesh.make_serve_mesh(4, device="cuda")
    assert mesh.shape == {"data": 1, "model": 2}
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert tmesh.make_serve_mesh(1, device="cuda").devices == \
        (torch.device("cuda", 0),)
