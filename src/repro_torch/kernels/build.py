"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and builds with ``nvcc``
into its own shared library, loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds.  Libraries land in ``build/kernels/`` at the
repository root (git-ignored), under a name keyed on the hash of the
source and the flags: a changed source rebuilds, an unchanged one loads
the existing library.  Nothing builds at import time; the first launch
(or ``build_all``) does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "ssd_scan", "mars_gather", "moe_dispatch",
           "flash_attention", "mars_engine", "dram_channel",
           "flash_attention_bwd", "embedding_grad_scatter")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    (target, temp path, process) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> str:
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)        # atomic: concurrent builders never race
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every kernel library, one ``nvcc`` per source, all started
    together.  Returns ``{name: compiler log}`` ("" when the library
    was already built)."""
    jobs = {n: _start(n) for n in names}
    try:
        return {n: ("" if job is None else _finish(n, job))
                for n, job in jobs.items()}
    finally:                      # a failed build stops the others
        for job in jobs.values():
            if job is not None and job[2].poll() is None:
                job[2].kill()
                job[2].wait()
                job[1].unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
