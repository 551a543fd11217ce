"""Fault tolerance on the port: checkpoints in the reference's on-disk
format (``repro_torch.ft.checkpoint``), the numpy manager
(``repro_torch.ft.manager``) and the trainer's kill-and-resume — the
reference's cases (``tests/test_ft.py``) on the port, its resharding
case as a restore onto a device and dtype — and checkpoints crossing
between the two packages: the JAX ``save`` restores in the port bit for
bit (float32, bfloat16 and int32 leaves and an AdamW state); the port's
``save`` restores in the JAX package bit for bit (float32 and int32
leaves) and writes the reference's files byte for byte (bfloat16 leaves
too: the reference's own ``restore`` cannot assign its ``'<V2'`` leaves
back, see ROADMAP.md §3); and a JAX checkpoint resumes in the port's
trainer, whose losses then follow the reference's uninterrupted run
(bf16 smoke model: 3e-4 relative, the two frameworks round bf16
products at other points; measured 6e-5)."""
import json
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.optim import adamw as joptim  # noqa: E402
from repro_torch.ft import checkpoint as ckpt  # noqa: E402
from repro_torch.ft.manager import (HeartbeatMonitor,  # noqa: E402
                                    StragglerDetector,
                                    optimal_ckpt_interval_steps,
                                    plan_elastic_mesh)
from repro_torch.optim import adamw as optim  # noqa: E402
from repro_torch.utils.tree import leaf_paths  # noqa: E402

torch.set_num_threads(1)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((16, 8), generator=g),
            "b": {"x": torch.arange(10, dtype=torch.float32),
                  "step": torch.tensor(7, dtype=torch.int32)}}


def _bits(x):
    """A leaf's bytes as numpy (bf16 as uint16, from either package)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same(got, want):
    g, w = dict(leaf_paths(got)), dict(leaf_paths(want))
    assert g.keys() == w.keys()
    for name in w:
        a, b = _bits(g[name]), _bits(w[name])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


# ---- the reference's cases (tests/test_ft.py) ------------------------------
def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(t, 5, tmp_path)
    assert ckpt.latest_step(tmp_path) == 5
    _assert_same(ckpt.restore(t, 5, tmp_path), t)


def test_checkpoint_gc_keeps_last_three(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(_tree(s), s, tmp_path)
    steps = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert len(steps) == 3
    assert ckpt.latest_step(tmp_path) == 5


def test_checkpoint_corruption_detected(tmp_path):
    t = _tree()
    d = ckpt.save(t, 1, tmp_path)
    shard = next((d / "shards").glob("*.npy"))
    arr = np.load(shard)
    arr.flat[0] += 1
    np.save(shard, arr)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(t, 1, tmp_path)


def test_checkpoint_restore_onto_device_and_dtype(tmp_path):
    """The reference's resharding case on one card: a restore lands on
    the device asked for, floating leaves in the dtype asked for."""
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(16, 4),
         "n": torch.tensor(3, dtype=torch.int32)}
    ckpt.save(t, 1, tmp_path)
    r = ckpt.restore(t, 1, tmp_path, device="cpu", dtype=torch.bfloat16)
    assert r["w"].device.type == "cpu" and r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"], t["w"].to(torch.bfloat16))
    assert r["n"].dtype == torch.int32 and int(r["n"]) == 3


def test_heartbeat_dead_host_detection(tmp_path):
    a = HeartbeatMonitor(tmp_path, host_id=0, timeout_s=0.2)
    b = HeartbeatMonitor(tmp_path, host_id=1, timeout_s=0.2)
    a.beat(1)
    b.beat(1)
    assert a.dead_hosts() == []
    time.sleep(0.3)
    a.beat(2)                      # host 0 alive, host 1 silent
    assert a.dead_hosts() == [1]


def test_straggler_detection():
    d = StragglerDetector(n_hosts=4, factor=1.5, patience=3)
    for step in range(10):
        for h in range(4):
            d.observe(h, 1.0 if h != 2 else 3.0)
        s = d.stragglers()
    assert s == [2]


def test_elastic_plan_preserves_model_axis():
    p = plan_elastic_mesh((2, 16, 16), ("pod", "data", "model"), 256)
    assert dict(zip(p.axis_names, p.mesh_shape))["model"] == 16
    assert np.prod(p.mesh_shape) <= 256
    # losing one pod keeps a full single-pod mesh
    assert p.mesh_shape == (1, 16, 16)


def test_elastic_plan_partial_loss():
    p = plan_elastic_mesh((2, 16, 16), ("pod", "data", "model"), 480)
    used = int(np.prod(p.mesh_shape))
    assert used <= 480 and used >= 448
    assert dict(zip(p.axis_names, p.mesh_shape))["model"] == 16


def test_elastic_plan_rejects_too_few():
    with pytest.raises(ValueError):
        plan_elastic_mesh((2, 16, 16), ("pod", "data", "model"), 8)


def test_young_daly_interval():
    # 1s steps, 30s checkpoints, 24h MTBF/host, 512 hosts
    n = optimal_ckpt_interval_steps(1.0, 30.0, 24.0, 512)
    assert 50 <= n <= 200, n
    # more hosts -> checkpoint more often
    n2 = optimal_ckpt_interval_steps(1.0, 30.0, 24.0, 2048)
    assert n2 < n


class _Killed(Exception):
    pass


def test_train_resume_exact(tmp_path, monkeypatch):
    """Kill-and-resume reproduces the uninterrupted run (the reference's
    rtol): a run killed after step 3 of 6 resumes from its checkpoint of
    step 2 (saved as step 3) and ends at the uninterrupted last loss."""
    from repro_torch.ft.manager import RunSupervisor
    from repro_torch.launch import train as train_mod
    argv = ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "6",
            "--batch", "2", "--seq", "32", "--ckpt-interval", "2",
            "--log-every", "100", "--device", "cpu"]
    full = train_mod.main(argv + ["--workdir", str(tmp_path / "a")])
    after_step = RunSupervisor.after_step

    def killing(self, step, dt):
        events = after_step(self, step, dt)
        if step == 3:
            raise _Killed
        return events
    monkeypatch.setattr(RunSupervisor, "after_step", killing)
    with pytest.raises(_Killed):
        train_mod.main(argv + ["--workdir", str(tmp_path / "b")])
    monkeypatch.setattr(RunSupervisor, "after_step", after_step)
    resumed = train_mod.run(argv + ["--workdir", str(tmp_path / "b"),
                                    "--resume"])
    assert resumed["start_step"] == 3
    np.testing.assert_allclose(resumed["losses"], full[3:], rtol=1e-4)


# ---- checkpoints across the two packages ----------------------------------
def _param_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"embed": {"tok": rng.standard_normal((12, 8))},
            "blocks": {"attn": {"wq": rng.standard_normal((2, 8, 2, 4)),
                                "bq": rng.standard_normal((2, 2, 4))}},
            "norm": {"scale": rng.standard_normal(8)}}


def _dtypes(bf16: bool):
    return {"embed": "bfloat16" if bf16 else "float32",
            "blocks": "bfloat16" if bf16 else "float32",
            "norm": "float32"}


def _both(bf16: bool):
    """The same parameters and AdamW state (after one update) in each
    package."""
    arrays, dts = _param_arrays(), _dtypes(bf16)
    jp = {k: jax.tree.map(lambda a, d=dts[k]: jnp.asarray(a, d), v)
          for k, v in arrays.items()}
    tp = {k: jax.tree.map(lambda a, d=dts[k]: torch.tensor(a).to(
        getattr(torch, d)), v) for k, v in arrays.items()}
    grads = _param_arrays(1)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jst = joptim.opt_init(jp, joptim.OptConfig(**cfg))
    jp, jst, _ = joptim.opt_update(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), grads), jst, jp,
        joptim.OptConfig(**cfg))
    tst = optim.opt_init(tp, optim.OptConfig(**cfg))
    tp, tst, _ = optim.opt_update(
        jax.tree.map(lambda a: torch.tensor(a, dtype=torch.float32), grads),
        tst, tp, optim.OptConfig(**cfg))
    return {"p": jp, "o": jst, "s": jnp.asarray(3)}, \
        {"p": tp, "o": tst, "s": torch.tensor(3, dtype=torch.int32)}


@pytest.mark.parametrize("bf16", [False, True])
def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, bf16):
    jtree, ttree = _both(bf16)
    jckpt.save(jtree, 3, tmp_path)
    got = ckpt.restore(ttree, 3, tmp_path)
    _assert_same(got, jtree)
    assert isinstance(got["o"], optim.AdamWState)
    assert got["o"].step.dtype == torch.int32 and int(got["s"]) == 3


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    _, ttree = _both(bf16=False)
    ckpt.save(ttree, 4, tmp_path)
    like = jax.tree.map(lambda t: np.zeros(t.shape, str(t.dtype).split(
        ".")[-1]) if isinstance(t, torch.Tensor) else 0, ttree,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    like["o"] = joptim.AdamWState(*like["o"])
    got = jckpt.restore(like, 4, tmp_path)
    _assert_same(got, ttree)


@pytest.mark.parametrize("bf16", [False, True])
def test_port_writes_the_reference_files_byte_for_byte(tmp_path, bf16):
    """Same tree, same files: the manifest (leaf names, shapes, dtypes,
    shard files, sha1s) and every ``.npy`` (bf16 as ``'<V2'``)."""
    jtree, ttree = _both(bf16)
    dj = jckpt.save(jtree, 2, tmp_path / "jax")
    dt = ckpt.save(ttree, 2, tmp_path / "port")
    mj = json.loads((dj / "manifest_0.json").read_text())
    mt = json.loads((dt / "manifest_0.json").read_text())
    assert mt == mj
    if bf16:
        assert any(e["dtype"] == "bfloat16" for e in mt["leaves"].values())
    files = sorted(p.name for p in (dj / "shards").iterdir())
    assert files == sorted(p.name for p in (dt / "shards").iterdir())
    for f in files:
        assert (dt / "shards" / f).read_bytes() == \
            (dj / "shards" / f).read_bytes(), f


def test_jax_checkpoint_resumes_in_the_port_trainer(tmp_path):
    """The reference's trainer runs 6 steps of the qwen smoke model and
    checkpoints after step 2 (saved as step 3); the port's trainer
    resumes from that checkpoint and its losses for steps 3-5 follow the
    reference's."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    argv = ["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "6",
            "--batch", "2", "--seq", "32", "--ckpt-interval", "2",
            "--log-every", "100", "--workdir", str(tmp_path)]
    want = jtrain.main(argv)
    assert jckpt.latest_step(tmp_path / "ckpt") == 3
    got = ttrain.run(argv + ["--device", "cpu", "--resume"])
    assert got["start_step"] == 3
    np.testing.assert_allclose(got["losses"], want[3:], rtol=3e-4)
