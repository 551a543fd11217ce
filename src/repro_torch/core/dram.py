"""The DRAM model's address map (port of the numpy half of
``repro/core/dram.py``).

Paper Section 2/4 memory system: dual-channel LPDDR4-3200, single rank,
8 banks, BL8, tCAS-tRCD-tRP = 15-15-15.  A 64B line is one BL8 burst;
the row buffer is 2 KB a bank a channel (32 lines), and a 4 KB OS page
maps to one (bank, row) pair in each channel, so the requests of one
page on one channel share a row.

This module holds the configuration, the result record and the address
map the live open-row model (``obs/rowsim.py``) shares with the
reference's controller: ``split_channels`` (channel striped at 128B)
and ``decode_lines`` (column, XOR-folded bank hash, row), on numpy,
element for element the reference's.  The FR-FCFS timing model
(``_run_channel``/``simulate``, a ``jax.lax.scan`` over served requests)
is not ported yet: it arrives with the paper simulator's slice, with
``core/mars.py`` and ``core/experiment.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
