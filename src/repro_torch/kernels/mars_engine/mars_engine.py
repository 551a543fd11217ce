"""The MARS cycle engine's wrapper (replaces the ``jax.lax.scan`` of
``repro/core/mars.py:247``).

``mars_engine`` runs the whole scan: on CUDA tensors it launches the
hand-written Hopper kernel ``csrc/mars_engine.cu`` (one block of one warp;
the source comment there gives its bound and design) or raises — there is
no fallback; on CPU tensors it runs the plain twin ``ref.mars_engine_plain``
and compacts its per-cycle emits the same way.  ``mars_engine.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.mars import n_cycles
from repro_torch.kernels import build
from repro_torch.kernels.mars_engine.ref import mars_engine_plain

MAX_REQUEST_Q = 1024      # the kernel keeps one free-bit word a lane


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("mars_engine")
    fn = lib.mars_engine_run
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_longlong] + [ctypes.c_void_p] * 3)
        err = lib.mars_engine_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _check(pages, port_req, port_len, src, cfg) -> None:
    for name, t in (("pages", pages), ("port_req", port_req),
                    ("port_len", port_len), ("src", src)):
        if t.dtype != torch.int32:
            raise TypeError(f"mars_engine: {name} must be int32, not "
                            f"{t.dtype}")
        if t.device != pages.device:
            raise ValueError(f"mars_engine: {name} is on {t.device}, pages "
                             f"on {pages.device}")
        if not t.is_contiguous():
            raise ValueError(f"mars_engine: {name} must be contiguous")
    n = pages.numel()
    if pages.dim() != 1 or src.shape != (n,) or port_req.dim() != 2 \
            or port_len.shape != (cfg.n_ports,) \
            or port_req.shape[0] != cfg.n_ports:
        raise ValueError(
            f"mars_engine takes pages and src (n,), port_req (n_ports, L) "
            f"and port_len (n_ports,) with n_ports {cfg.n_ports}; got "
            f"{tuple(pages.shape)}, {tuple(src.shape)}, "
            f"{tuple(port_req.shape)}, {tuple(port_len.shape)}")
    if not 0 < cfg.request_q <= MAX_REQUEST_Q:
        raise ValueError(f"mars_engine takes a RequestQ of 1 to "
                         f"{MAX_REQUEST_Q} entries, not {cfg.request_q}")
    if cfg.nsets < 1 or cfg.ways < 1:
        raise ValueError(f"mars_engine needs at least one set and one way "
                         f"(page_entries {cfg.page_entries}, ways "
                         f"{cfg.ways})")


def _launch(pages, port_req, port_len, src, n_cores: int, cfg):
    """Launch the CUDA kernel on the current stream."""
    dev = pages.device
    n = pages.numel()
    perm = torch.full((n,), -1, dtype=torch.int64, device=dev)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_engine_run(
        pages.data_ptr(), port_req.data_ptr(), port_len.data_ptr(),
        src.data_ptr(), n, port_req.shape[1], max(n_cores, 1),
        cfg.request_q, cfg.nsets, cfg.ways, cfg.order_q, cfg.n_ports,
        cfg.mshr_per_core, n_cycles(n, cfg), perm.data_ptr(),
        stats.data_ptr(), stream)
    if rc != 0:
        why = {-1: "unsupported argument",
               -2: "state larger than a block's shared memory"}.get(rc) \
            or lib.mars_engine_error_string(rc).decode()
        raise RuntimeError(f"mars_engine kernel launch failed: rc={rc} "
                           f"({why})")
    mars_engine.launches += 1
    return perm, stats


def mars_engine(pages: torch.Tensor, port_req: torch.Tensor,
                port_len: torch.Tensor, src: torch.Tensor, n_cores: int,
                cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the reference's ``_run`` scan over ``pages``/``src`` (int32
    (n,)), ``port_req`` (int32 (n_ports, L), -1 padded) and ``port_len``
    (int32 (n_ports,)) under ``cfg`` (a ``MarsConfig``).

    Returns (perm, stats) on the tensors' device: ``perm`` int64 (n,), the
    forwarded original indices in order (-1 past the count forwarded);
    ``stats`` int32 (3,) = (forwarded, stall events, cycle of the last
    forward + 1).  CUDA tensors launch the kernel; CPU tensors run the
    plain twin."""
    _check(pages, port_req, port_len, src, cfg)
    if pages.numel() == 0:
        return (torch.zeros(0, dtype=torch.int64, device=pages.device),
                torch.zeros(3, dtype=torch.int32, device=pages.device))
    if pages.device.type == "cuda":
        return _launch(pages, port_req, port_len, src, n_cores, cfg)
    if pages.device.type != "cpu":
        raise ValueError(f"mars_engine runs on cuda or cpu, not "
                         f"{pages.device}")
    n = pages.numel()
    emits, stalls = mars_engine_plain(pages.numpy(), port_req.numpy(),
                                      port_len.numpy(), src.numpy(), n,
                                      n_cores, cfg)
    cycles = np.flatnonzero(emits >= 0)
    out = emits[cycles].astype(np.int64)
    perm = torch.full((n,), -1, dtype=torch.int64)
    perm[:min(len(out), n)] = torch.from_numpy(out[:n])
    last = int(cycles[-1]) + 1 if len(cycles) else 0
    return perm, torch.tensor([len(out), stalls, last], dtype=torch.int32)


mars_engine.launches = 0
