"""The PyTorch port stands alone: importing it pulls in no JAX, no port
file imports JAX, ``ml_dtypes`` or the JAX package, and its entry points
refuse to run on a CUDA device that is not there instead of falling back
to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SLICE_MODULES = [
    "repro_torch",
    "repro_torch.analysis.lint",
    "repro_torch.analysis.races",
    "repro_torch.analysis.refsan",
    "repro_torch.benchmarks.ablations",
    "repro_torch.benchmarks.kernel_benches",
    "repro_torch.benchmarks.kvcache_sim",
    "repro_torch.benchmarks.paper_figures",
    "repro_torch.benchmarks.run",
    "repro_torch.configs",
    "repro_torch.configs.arctic_480b",
    "repro_torch.configs.deepseek_coder_33b",
    "repro_torch.configs.hymba_1_5b",
    "repro_torch.configs.kimi_k2_1t_a32b",
    "repro_torch.configs.mamba2_370m",
    "repro_torch.configs.paligemma_3b",
    "repro_torch.configs.phi3_medium_14b",
    "repro_torch.configs.qwen1_5_0_5b",
    "repro_torch.configs.starcoder2_7b",
    "repro_torch.configs.whisper_base",
    "repro_torch.convert",
    "repro_torch.core.dram",
    "repro_torch.core.experiment",
    "repro_torch.core.mars",
    "repro_torch.core.reorder",
    "repro_torch.core.streams",
    "repro_torch.data.pipeline",
    "repro_torch.device",
    "repro_torch.ft.checkpoint",
    "repro_torch.ft.manager",
    "repro_torch.kernels.build",
    "repro_torch.kernels.dram_channel.dram_channel",
    "repro_torch.kernels.dram_channel.ref",
    "repro_torch.kernels.flash_attention.flash_attention",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.mars_engine.mars_engine",
    "repro_torch.kernels.mars_engine.ref",
    "repro_torch.kernels.mars_gather.mars_gather",
    "repro_torch.kernels.mars_gather.ops",
    "repro_torch.kernels.mars_gather.ref",
    "repro_torch.kernels.moe_dispatch.moe_dispatch",
    "repro_torch.kernels.moe_dispatch.ops",
    "repro_torch.kernels.moe_dispatch.ref",
    "repro_torch.kernels.paged_attention.ops",
    "repro_torch.kernels.paged_attention.paged_attention",
    "repro_torch.kernels.paged_attention.ref",
    "repro_torch.kernels.ssd_scan.ref",
    "repro_torch.kernels.ssd_scan.ssd_scan",
    "repro_torch.kvcache",
    "repro_torch.kvcache.backend",
    "repro_torch.kvcache.evict",
    "repro_torch.kvcache.placement",
    "repro_torch.kvcache.pool",
    "repro_torch.kvcache.prefix",
    "repro_torch.kvcache.sharded_pool",
    "repro_torch.kvcache.tiers",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
    "repro_torch.launch.roofline",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.models.config",
    "repro_torch.models.layers",
    "repro_torch.models.lm",
    "repro_torch.models.moe",
    "repro_torch.models.ssm",
    "repro_torch.obs",
    "repro_torch.obs.metrics",
    "repro_torch.obs.observer",
    "repro_torch.obs.rowsim",
    "repro_torch.obs.trace",
    "repro_torch.optim.adamw",
    "repro_torch.serve.engine",
    "repro_torch.serve.step",
    "repro_torch.serving.scheduler",
    "repro_torch.sharding.context",
    "repro_torch.sharding.dtensor",
    "repro_torch.sharding.rules",
    "repro_torch.train.step",
    "repro_torch.utils.collectives",
    "repro_torch.utils.tree",
]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes',"
            " 'repro'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("module", [
    "repro_torch.kvcache.tiers", "repro_torch.kvcache.sharded_pool",
    "repro_torch.sharding.context", "repro_torch.launch.mesh"])
def test_tier_and_shard_modules_leave_jax_out(module):
    """Each module of the tiered and sharded serve path, imported alone
    in a fresh interpreter, loads no JAX."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "assert 'jax' not in sys.modules\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("module", [
    "repro_torch.obs", "repro_torch.analysis.races",
    "repro_torch.analysis.refsan", "repro_torch.core.dram",
    "repro_torch.core.streams"])
def test_obs_and_analysis_modules_leave_jax_and_repro_out(module):
    """Each module of the telemetry and sanitizer slice, imported alone in
    a fresh interpreter, loads neither JAX nor the JAX package (the
    reference's ``obs`` reaches JAX through ``core/dram``)."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("module", [
    "repro_torch.core.mars", "repro_torch.core.dram",
    "repro_torch.core.experiment", "repro_torch.benchmarks.run",
    "repro_torch.benchmarks.paper_figures", "repro_torch.benchmarks.ablations",
    "repro_torch.benchmarks.kvcache_sim"])
def test_simulator_modules_leave_jax_and_repro_out(module):
    """Each module of the paper simulator's slice, imported alone in a
    fresh interpreter (the benchmarks' sections too), loads neither JAX
    nor the JAX package."""
    code = (f"import importlib, sys\nm = importlib.import_module({module!r})\n"
            "getattr(m, 'sections', lambda d: None)('cpu')\n"
            "assert 'jax' not in sys.modules\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("module", [
    "repro_torch.launch.train", "repro_torch.train.step",
    "repro_torch.optim.adamw", "repro_torch.ft.checkpoint",
    "repro_torch.ft.manager", "repro_torch.data.pipeline"])
def test_training_modules_leave_jax_and_repro_out(module):
    """Each module of the training slice, imported alone in a fresh
    interpreter, loads neither JAX nor the JAX package."""
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\nprint('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_train_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "qwen1_5_0_5b", "--steps", "1",
                    "--workdir", str(tmp_path)])


def test_races_cli_runs_as_a_module(tmp_path):
    """``python -m repro_torch.analysis.races`` replays a trace file and
    exits 1 on a violation (here: no pipelined decode at all)."""
    trace = tmp_path / "trace.jsonl"
    trace.write_text('{"ts": 0, "ev": "engine.token", "rid": 0}\n')
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.races",
                          str(trace), "--require-pipeline"], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    assert "[races] BAD" in out.stdout and "RuntimeWarning" not in out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_is_covered():
    """Each module of the package is in the import check above."""
    found = {".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
             .removesuffix(".__init__")
             for p in PORT.rglob("*.py")}
    inits = {m for m in found if (ROOT / "src" / m.replace(".", "/")
                                  / "__init__.py").exists()}
    assert found - inits <= set(SLICE_MODULES), \
        sorted(found - inits - set(SLICE_MODULES))


def test_serve_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--paged", "--smoke", "--requests", "1"])


@pytest.mark.parametrize("arch", ["whisper_base", "mamba2_370m"])
def test_dense_serve_defaults_to_cuda_and_raises_without_it(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--config", arch, "--smoke", "--requests", "1"])


@pytest.mark.parametrize("entry", ["dense_backend", "paged_backend",
                                   "sharded_backend", "serve_mesh",
                                   "toy_engine"])
def test_entry_points_raise_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import configs
    from repro_torch.kvcache import BlockPool, PoolConfig
    from repro_torch.kvcache.backend import make_backend
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serving.scheduler import MarsScheduler
    cfg = configs.get_smoke("qwen1_5_0_5b")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "dense_backend":
            make_backend(cfg, "dense", batch=1, max_seq=8)
        elif entry == "paged_backend":
            make_backend(cfg, "paged", batch=1, max_seq=8)
        elif entry == "sharded_backend":
            make_backend(cfg, "paged", shards=2, batch=2, max_seq=8)
        elif entry == "serve_mesh":
            from repro_torch.launch.mesh import make_serve_mesh
            make_serve_mesh(2)
        else:
            pool = BlockPool(PoolConfig(num_blocks=8, n_kv_heads=2,
                                        head_dim=64))
            ServeEngine(pool, MarsScheduler(pool=pool))


def test_kernel_wrapper_never_falls_back():
    """A CUDA-bound launch with operands the kernel takes goes to the
    build (which needs nvcc) — it never computes the plain twin instead;
    operands the kernel does not take raise before that."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import paged_attention as pa
    q = torch.zeros(1, 2, 64)
    kp = torch.zeros(1, 3, 4, 2, 64)
    pt = torch.zeros(1, 1, dtype=torch.int32)
    ln = torch.ones(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        pa._launch(q, kp, kp, pt.long(), ln, 0, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa._launch(q.half(), kp.half(), kp.half(), pt, ln, 0, 0)
    with pytest.raises(ValueError, match="head_dim"):
        pa._launch(q[..., :32].contiguous(), kp[..., :32].contiguous(),
                   kp[..., :32].contiguous(), pt, ln, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        pa._launch(torch.zeros(1, 2, 128)[..., ::2], kp, kp, pt, ln, 0, 0)
    with pytest.raises(ValueError, match="layer"):
        pa._launch(q, kp, kp, pt, ln, 1, 0)
    launches = pa.paged_attention.launches
    try:
        build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            pa._launch(q, kp, kp, pt, ln, 0, 0)
    assert pa.paged_attention.launches == launches


@pytest.mark.parametrize("where", ["lone_directory", "checkout"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if where == "lone_directory":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
