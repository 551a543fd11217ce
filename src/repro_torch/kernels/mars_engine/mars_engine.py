"""The MARS cycle engine's wrapper (replaces the ``jax.lax.scan`` of
``repro/core/mars.py:247``).

``mars_engine_many`` runs the whole scan for any number of independent
instances, each a stream under its own ``MarsConfig``: on CUDA tensors
it launches the hand-written Hopper kernel ``csrc/mars_engine.cu`` once
for all of them (one block an instance; the source comment there gives
its bounds and design) or raises — there is no fallback; on CPU tensors
it runs the plain twin ``ref.mars_engine_plain`` instance by instance
and compacts its per-cycle emits the same way.  ``mars_engine`` is its
one-instance case.  ``mars_engine.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.mars import n_cycles
from repro_torch.kernels import build
from repro_torch.kernels.mars_engine.ref import mars_engine_plain

MAX_REQUEST_Q = 1024      # the kernel's bound on the RequestQ
MAX_PORTS = 32            # the active-port mask is one word
MAX_WAYS = 32             # a set's valid ways are one word
N_PARAMS = 16             # int64s a row of the kernel's `params`


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("mars_engine")
    fn = lib.mars_engine_run
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
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
    if not 0 < cfg.n_ports <= MAX_PORTS:
        raise ValueError(f"mars_engine takes 1 to {MAX_PORTS} n_ports, not "
                         f"{cfg.n_ports}")
    if cfg.nsets < 1 or not 0 < cfg.ways <= MAX_WAYS:
        raise ValueError(f"mars_engine needs at least one set and 1 to "
                         f"{MAX_WAYS} ways (page_entries "
                         f"{cfg.page_entries}, ways {cfg.ways})")


def _params(items) -> torch.Tensor:
    """The kernel's int64 ``params`` rows (see ``csrc/mars_engine.cu``):
    each instance's offsets into the concatenated operands and its
    configuration."""
    rows, off, req_off, len_off = [], 0, 0, 0
    for pages, port_req, port_len, src, n_cores, cfg in items:
        n = pages.numel()
        rows.append([off, n, req_off, port_req.shape[1], len_off,
                     cfg.n_ports, max(n_cores, 1), cfg.request_q, cfg.nsets,
                     cfg.ways, cfg.order_q, cfg.mshr_per_core,
                     n_cycles(n, cfg)] + [0] * (N_PARAMS - 13))
        off += n
        req_off += port_req.numel()
        len_off += port_len.numel()
    return torch.tensor(rows, dtype=torch.int64)


def _launch_many(items) -> list:
    """Launch the CUDA kernel once, on the current stream, for every
    instance of ``items``."""
    dev = items[0][0].device
    pages, port_req, port_len, src = (
        torch.cat([it[i].reshape(-1) for it in items]) for i in range(4))
    params = _params(items)
    # the kernel's copy, without waiting for the stream: pinned, async
    params_dev = (params.pin_memory() if dev.type == "cuda" else params) \
        .to(dev, non_blocking=True)
    perm = torch.full((pages.numel(),), -1, dtype=torch.int64, device=dev)
    stats = torch.zeros((len(items), 3), dtype=torch.int32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_engine_run(
        pages.data_ptr(), src.data_ptr(), port_req.data_ptr(),
        port_len.data_ptr(), params.data_ptr(), params_dev.data_ptr(),
        len(items), perm.data_ptr(), stats.data_ptr(), stream)
    if rc != 0:
        why = {-1: "unsupported argument",
               -2: "state larger than a block's shared memory"}.get(rc) \
            or lib.mars_engine_error_string(rc).decode()
        raise RuntimeError(f"mars_engine kernel launch failed: rc={rc} "
                           f"({why})")
    mars_engine.launches += 1
    bounds = params[:, 0].tolist() + [pages.numel()]
    return [(perm[a:b], stats[i])
            for i, (a, b) in enumerate(zip(bounds, bounds[1:]))]


def _launch(pages, port_req, port_len, src, n_cores: int, cfg):
    """Launch the CUDA kernel for one instance on the current stream."""
    return _launch_many([(pages, port_req, port_len, src, n_cores, cfg)])[0]


def _plain(pages, port_req, port_len, src, n_cores: int, cfg):
    """The plain twin on CPU tensors, compacted as the kernel's output."""
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


def mars_engine_many(items) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Run the reference's ``_run`` scan for every instance of ``items``,
    each ``(pages, port_req, port_len, src, n_cores, cfg)`` as
    ``mars_engine`` takes them; all on one device.

    Returns one (perm, stats) an instance, as ``mars_engine``.  On CUDA
    tensors every instance with a request goes to one kernel launch; on
    CPU tensors each runs the plain twin."""
    items = list(items)
    for it in items:
        _check(*it[:4], it[5])
        if it[0].device != items[0][0].device:
            raise ValueError(f"mars_engine_many: instances on "
                             f"{items[0][0].device} and {it[0].device}")
    out = [(torch.zeros(0, dtype=torch.int64, device=it[0].device),
            torch.zeros(3, dtype=torch.int32, device=it[0].device))
           for it in items]
    busy = [i for i, it in enumerate(items) if it[0].numel()]
    if not busy:
        return out
    dev = items[0][0].device
    if dev.type == "cuda":
        for i, res in zip(busy, _launch_many([items[i] for i in busy])):
            out[i] = res
        return out
    if dev.type != "cpu":
        raise ValueError(f"mars_engine runs on cuda or cpu, not {dev}")
    for i in busy:
        out[i] = _plain(*items[i])
    return out


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
    return mars_engine_many([(pages, port_req, port_len, src, n_cores,
                              cfg)])[0]


mars_engine.launches = 0
