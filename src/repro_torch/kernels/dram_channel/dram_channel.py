"""The FR-FCFS channel model's wrapper (replaces the ``jax.lax.scan`` of
``repro/core/dram.py:219``).

``dram_channels`` serves every channel's stream in one call (the channels
of any number of streams, laid back to back by ``core.dram.simulate_many``):
on CUDA tensors it launches the hand-written Hopper kernel
``csrc/dram_channel.cu`` (one warp a channel, all channels in one launch;
the source comment there gives its bounds and design) or raises — there
is no fallback; on CPU tensors it runs the plain twin
``ref.run_channel_plain`` channel by channel.  ``dram_channels.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dram_channel.ref import BIG, run_channel_plain

MAX_WINDOW = 256          # 8 window slots a lane
MAX_BANKS = 32            # one bank a lane


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signatures declared."""
    lib = build.load("dram_channel")
    fn = lib.dram_channels_run
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p] * 2)
        err = lib.dram_channel_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _check(local, is_write, offsets, cfg) -> None:
    for name, t, dt in (("local", local, torch.int32),
                        ("is_write", is_write, torch.uint8),
                        ("offsets", offsets, torch.int64)):
        if t.dtype != dt:
            raise TypeError(f"dram_channels: {name} must be {dt}, not "
                            f"{t.dtype}")
        if t.device != local.device:
            raise ValueError(f"dram_channels: {name} is on {t.device}, "
                             f"local on {local.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"dram_channels: {name} must be 1-D and "
                             f"contiguous")
    if is_write.shape != local.shape or offsets.numel() < 1:
        raise ValueError(f"dram_channels: is_write {tuple(is_write.shape)} "
                         f"must match local {tuple(local.shape)}, and "
                         f"offsets hold n_channels + 1 entries")
    if local.numel() >= BIG:
        raise ValueError(f"dram_channels takes fewer than {BIG} requests "
                         f"(arrivals key the window), not {local.numel()}")
    if not 1 <= cfg.window <= MAX_WINDOW:
        raise ValueError(f"dram_channels takes a window of 1 to "
                         f"{MAX_WINDOW} entries, not {cfg.window}")
    if not 1 <= cfg.n_banks <= MAX_BANKS:
        raise ValueError(f"dram_channels takes 1 to {MAX_BANKS} banks, not "
                         f"{cfg.n_banks}")


def _launch(local, is_write, offsets, cfg) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    dev = local.device
    n_channels = offsets.numel() - 1
    out = torch.zeros((n_channels, 3), dtype=torch.int32, device=dev)
    if n_channels == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.dram_channels_run(
        local.data_ptr(), is_write.data_ptr(), offsets.data_ptr(),
        n_channels, cfg.window, cfg.n_banks, cfg.lines_per_row, cfg.t_rcd,
        cfg.t_rp, cfg.t_burst, cfg.t_ccd, cfg.t_rrd, cfg.t_faw, cfg.t_wtr,
        cfg.t_rtw, out.data_ptr(), stream)
    if rc != 0:
        why = "unsupported argument" if rc < 0 \
            else lib.dram_channel_error_string(rc).decode()
        raise RuntimeError(f"dram_channels kernel launch failed: rc={rc} "
                           f"({why})")
    dram_channels.launches += 1
    return out


def dram_channels(local: torch.Tensor, is_write: torch.Tensor,
                  offsets: torch.Tensor, cfg) -> torch.Tensor:
    """Serve each channel's requests through the FR-FCFS window.

    ``local``: int32 channel-local line ids of every channel back to back,
    in arrival order; ``is_write``: uint8 flags, the same layout;
    ``offsets``: int64 (n_channels + 1,), channel c's requests at
    ``[offsets[c], offsets[c + 1])``; ``cfg`` a ``DramConfig``.  Returns
    int32 (n_channels, 3) = (t_end, n_act, hits) a channel, on the
    tensors' device.  CUDA tensors launch the kernel; CPU tensors run the
    plain twin."""
    _check(local, is_write, offsets, cfg)
    if local.device.type == "cuda":
        return _launch(local, is_write, offsets, cfg)
    if local.device.type != "cpu":
        raise ValueError(f"dram_channels runs on cuda or cpu, not "
                         f"{local.device}")
    bounds = offsets.tolist()
    rows = [run_channel_plain(local[a:b].tolist(), is_write[a:b].tolist(),
                              cfg) for a, b in zip(bounds, bounds[1:])]
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 3)


dram_channels.launches = 0
