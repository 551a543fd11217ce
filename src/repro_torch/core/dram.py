"""LPDDR4-3200 dual-channel DRAM timing model with an FR-FCFS controller
(port of ``repro/core/dram.py``).

Paper Section 2/4 memory system: dual-channel LPDDR4-3200, single rank,
8 banks, BL8, tCAS-tRCD-tRP = 15-15-15.  The controller has a *small*
pending-queue window per channel (the realistic baseline — row-hit-first
scheduling inside a limited lookahead).  MARS's whole premise is that this
window is too small to recover locality that multi-level arbitration
destroyed, while naively growing it is impractical.

Model (documented simplifications):
  * unit = DRAM command clock @ 1.6 GHz (LPDDR4-3200 => 2 transfers/clock)
  * one 64B line = BL8 burst = 4 data-bus clocks; per-channel peak
    bandwidth = 64 B / 4 clk = 25.6 GB/s, 51.2 GB/s total
  * row buffer 2 KB/bank/channel (32 lines); a 4 KB OS page maps to one
    (bank, row) pair in each channel -> requests of one page on one channel
    share a row, exactly the paper's memory-map-agnostic locality argument
  * row hit:   data start >= max(bus_free, bank_ready)
    row miss:  PRE (tRP, if a row was open) + ACT (ACT->CAS tRCD) off the
    critical path of other banks' transfers; tFAW (max 4 ACTs / 40 clk) and
    tRRD (8 clk) limit activate rate — these are what make a low CAS/ACT
    stream bandwidth-bound
  * read<->write direction switches pay a bus-turnaround penalty
    (tWTR / tRTW), so mixed-direction streams cap below pure-stream peak

The address map (``split_channels``, ``decode_lines``) is numpy, element
for element the reference's, and shared with the live open-row model
(``obs/rowsim.py``).  ``simulate`` serves every channel's stream, one
request a step, through the FR-FCFS window, and ``simulate_many`` the
channels of several streams at once: on a CUDA device in one launch of
the hand-written kernel ``csrc/dram_channel.cu`` (one warp a channel), on
the CPU through its plain twin (``kernels/dram_channel/ref.py``); both
give the reference's ``_run_channel`` integers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DramConfig:
    n_channels: int = 2
    n_banks: int = 8
    lines_per_row: int = 32     # 2KB row buffer / 64B lines
    t_cas: int = 15
    t_rcd: int = 15
    t_rp: int = 15
    t_burst: int = 4            # BL8 @ 2 transfers/clock
    t_ccd: int = 4
    t_rrd: int = 8
    t_faw: int = 40
    t_wtr: int = 12             # write->read bus turnaround
    t_rtw: int = 8              # read->write bus turnaround
    window: int = 32            # MC pending-queue entries per channel
    clock_ghz: float = 1.6
    line_bytes: int = 64

    @property
    def peak_gbps(self) -> float:
        return self.n_channels * self.line_bytes / self.t_burst * self.clock_ghz


@dataclasses.dataclass(frozen=True)
class DramResult:
    cycles: int
    n_requests: int
    n_act: int
    achieved_gbps: float
    bus_utilization: float
    cas_per_act: float
    per_channel_cycles: tuple


def split_channels(addr: np.ndarray, cfg: DramConfig):
    """Address map: channel striped at 128B; within a channel the local
    line id is contiguous per page (see module docstring)."""
    a = np.asarray(addr, np.int64)
    if cfg.n_channels & (cfg.n_channels - 1):
        raise ValueError(
            f"n_channels must be a power of two, got {cfg.n_channels}: the "
            "128B channel stripe extracts the channel id as a bit field")
    ch_bits = int(np.log2(cfg.n_channels))
    ch = (a >> 1) & (cfg.n_channels - 1)
    local = ((a >> (1 + ch_bits)) << 1) | (a & 1)
    return ch, local


def _decode(local: np.ndarray, cfg: DramConfig):
    col = local % cfg.lines_per_row
    row = local // (cfg.lines_per_row * cfg.n_banks)
    # bank-address hashing (XOR-fold ALL row/page bits into the bank
    # select) — standard MC practice to break stride-induced bank
    # conflicts at any power-of-two stride
    k = max(1, (cfg.n_banks - 1).bit_length())
    page = local // cfg.lines_per_row
    b = page
    x = page >> k
    for _ in range(max(1, (31 + k - 1) // k)):
        b = b ^ x
        x = x >> k
    bank = b % cfg.n_banks
    return col, bank, row


def decode_lines(local: np.ndarray, cfg: DramConfig):
    """Public (col, bank, row) decode of channel-local line ids: the map
    the reference's FR-FCFS controller uses, shared with the live
    open-row model in ``obs/rowsim.py``."""
    return _decode(np.asarray(local), cfg)


def channel_operands(addr: np.ndarray, cfg: DramConfig,
                     is_write: np.ndarray | None = None):
    """The channel model's operands for a stream: each channel's line ids
    (int32, as the reference casts them) and write flags (uint8) in
    arrival order, channels back to back, and the int64 offsets of the
    channels (``n_channels + 1``)."""
    ch, local = split_channels(addr, cfg)
    if is_write is None:
        is_write = np.zeros(len(ch), bool)
    order = np.argsort(ch, kind="stable")
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(ch, minlength=cfg.n_channels))])
    return (local[order].astype(np.int32),
            np.asarray(is_write, bool)[order].astype(np.uint8),
            offsets.astype(np.int64))


def simulate_many(streams, cfg: DramConfig | None = None, *,
                  device="cuda") -> list[DramResult]:
    """Serve several independent streams, each ``(addr, is_write)`` as
    ``simulate`` takes them (``is_write`` may be None), and report one
    ``DramResult`` a stream, each equal to ``simulate`` on it.  Every
    stream's channels go back to back into one ``channel_operands``
    layout, so ``device="cuda"`` (the default) serves all of them in one
    launch of the CUDA kernel and raises without a GPU; ``device="cpu"``
    runs its plain twin."""
    from repro_torch.kernels.dram_channel.dram_channel import dram_channels
    cfg = cfg or DramConfig()
    dev = resolve_device(device)
    streams = list(streams)
    if not streams:
        return []
    ops = [channel_operands(addr, cfg, is_write) for addr, is_write in streams]
    shift = np.cumsum([0] + [len(o[0]) for o in ops])
    offsets = np.concatenate(
        [o[2][:-1] + s for o, s in zip(ops, shift)] + [shift[-1:]])
    res = dram_channels(*(torch.from_numpy(a).to(dev) for a in (
        np.concatenate([o[0] for o in ops]),
        np.concatenate([o[1] for o in ops]), offsets)), cfg).cpu()
    C = cfg.n_channels
    return [_result(res[i * C:(i + 1) * C], len(addr), cfg)
            for i, (addr, _) in enumerate(streams)]


def _result(rows: torch.Tensor, n_total: int, cfg: DramConfig) -> DramResult:
    """A stream's ``DramResult`` from its channels' (t_end, n_act, hits)."""
    t_ends = [int(v) for v in rows[:, 0]]
    n_act = int(rows[:, 1].sum())
    cycles = max(t_ends) if t_ends else 0
    secs = cycles / (cfg.clock_ghz * 1e9) if cycles else 1.0
    gbps = n_total * cfg.line_bytes / secs / 1e9 if cycles else 0.0
    return DramResult(
        cycles=cycles, n_requests=n_total, n_act=max(n_act, 1),
        achieved_gbps=gbps,
        bus_utilization=gbps / cfg.peak_gbps if cycles else 0.0,
        cas_per_act=n_total / max(n_act, 1),
        per_channel_cycles=tuple(t_ends),
    )


def simulate(addr: np.ndarray, cfg: DramConfig | None = None,
             is_write: np.ndarray | None = None, *,
             device="cuda") -> DramResult:
    """Serve ``addr`` (64B-line ids, already in arrival order) and report
    achieved bandwidth + CAS/ACT: ``simulate_many``'s one-stream case.
    ``device="cuda"`` (the default) serves the channels in one launch of
    the CUDA kernel and raises without a GPU; ``device="cpu"`` runs its
    plain twin."""
    return simulate_many([(addr, is_write)], cfg, device=device)[0]
