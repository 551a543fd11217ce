"""Incremental open-row model: live row-buffer hit accounting (port of
``repro/obs/rowsim.py``).

The reference's ``core/dram.simulate`` answers "what row-hit rate did
this trace get?" by replaying the whole address stream through its
FR-FCFS timing model — fine for benches, far too heavy for every decode
step.  This module is the hit-accounting half of that controller as an
*incremental* counter: same channel split (``dram.split_channels``),
same bank hash and row decode (``dram.decode_lines``), same per-bank
open-row registers, but no timing — just "would this access have hit the
open row?", carried across ``observe()`` calls so the serving stack can
publish a running row-hit % gauge.

Two serve-order models:

  * ``window=1`` (default): in-order service, fully vectorized numpy —
    a stable sort groups each batch by bank and compares every access's
    row against its predecessor in the same bank (the persistent open
    row for the first of each bank group).  For the kernel decode path's
    page walk (``ops.kv_read_trace_kernel`` — sequence-major, page-
    contiguous) in-order service is *exactly* what the FR-FCFS window
    produces: the stream has no interleaving left for lookahead to
    reorder, so the live gauge matches the reference's ``dram.simulate``
    replay to the digit (pinned within 0.1% by
    ``tests/test_torch_obs.py``).  Cost is O(n log n) per step.  The walk
    is the order of the reference's Pallas grid (lanes one after
    another) on the paper's LPDDR4 map: a model, not the order of the
    port's K1, which walks page ranges of every lane at once on HBM3.
  * ``window=W>1``: a faithful Python replay of the controller's
    FR-FCFS pick (row hits first, oldest first, inside a W-entry
    pending window).  O(W) per access — verification tool for arbitrary
    interleaved traces (e.g. the gather path's round-robin stream,
    where in-order and windowed service genuinely diverge), not a hot
    path.  Windowed mode buffers up to W accesses; call ``drain()``
    before reading final counts.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.dram import DramConfig, decode_lines, split_channels


class OpenRowCounter:
    """Running row-hit counter over an incrementally observed 64B-line
    address stream (same address map as ``core/dram.py``)."""

    def __init__(self, cfg: Optional[DramConfig] = None, window: int = 1):
        self.cfg = cfg or DramConfig()
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self.hits = 0
        self.served = 0
        # persistent per-(channel, bank) open row; -1 = closed
        self._open = np.full((self.cfg.n_channels, self.cfg.n_banks),
                             -1, np.int64)
        # windowed mode: per-channel pending (arrival, bank, row) queues
        self._pending = [deque() for _ in range(self.cfg.n_channels)]
        self._arrival = 0

    def observe(self, addr) -> None:
        """Account a batch of line addresses (arrival order preserved)."""
        addr = np.asarray(addr, np.int64)
        if addr.size == 0:
            return
        ch, local = split_channels(addr, self.cfg)
        for c in range(self.cfg.n_channels):
            l = local[ch == c]
            if l.size == 0:
                continue
            _, bank, row = decode_lines(l, self.cfg)
            if self.window == 1:
                self._serve_inorder(c, np.asarray(bank), np.asarray(row))
            else:
                self._enqueue_windowed(c, bank, row)

    def _serve_inorder(self, c: int, bank: np.ndarray,
                       row: np.ndarray) -> None:
        # stable sort by bank keeps arrival order inside each bank group,
        # so "previous row in this bank" is one shifted comparison
        order = np.argsort(bank, kind="stable")
        b, r = bank[order], row[order]
        same_bank = np.concatenate(([False], b[1:] == b[:-1]))
        prev = np.where(same_bank,
                        np.concatenate(([-1], r[:-1])),   # shifted rows
                        self._open[c][b])                 # carry-in
        self.hits += int(np.count_nonzero(prev == r))
        self.served += b.size
        last = np.concatenate((b[1:] != b[:-1], [True]))  # group tails
        self._open[c][b[last]] = r[last]

    # -- windowed FR-FCFS replay (verification mode) --------------------

    def _enqueue_windowed(self, c: int, bank, row) -> None:
        q = self._pending[c]
        for b, r in zip(bank.tolist(), row.tolist()):
            if len(q) >= self.window:
                self._serve_one(c)
            q.append((self._arrival, int(b), int(r)))
            self._arrival += 1

    def _serve_one(self, c: int) -> None:
        # FR-FCFS pick: oldest row hit if any, else oldest.  The queue is
        # kept in arrival order, so the first hit scanned is the oldest.
        q = self._pending[c]
        pick = None
        for i, (_, b, r) in enumerate(q):
            if self._open[c, b] == r:
                pick = i
                break
        if pick is None:
            pick = 0
        else:
            self.hits += 1
        _, b, r = q[pick]
        del q[pick]
        self._open[c, b] = r
        self.served += 1

    def drain(self) -> None:
        """Serve out any pending windowed accesses (no-op for window=1)."""
        for c in range(self.cfg.n_channels):
            while self._pending[c]:
                self._serve_one(c)

    @property
    def row_hit_rate(self) -> float:
        """Hits over accesses *served* so far (0.0 before any traffic)."""
        return self.hits / self.served if self.served else 0.0

    def __repr__(self):
        return (f"OpenRowCounter(window={self.window}, served={self.served}, "
                f"row_hit_rate={self.row_hit_rate:.4f})")
