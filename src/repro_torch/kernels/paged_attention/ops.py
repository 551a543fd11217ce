"""Pool -> kernel bridge (port of ``repro/kernels/paged_attention/ops.py``).

  ``pool_page_tables``     pad per-sequence ``BlockTable``s into the dense
                           ``(B, n_pages)`` int32 operand the kernel reads
                           (optionally lane-padded)
  ``decode_step_operands`` one ragged decode step's full operand pack —
                           pow2-padded page tables, lengths, and the
                           ``(Bp, 1)`` token batch
  ``batch_lane_order``     order decode lanes so sequences whose tail blocks
                           share a DRAM row neighborhood sit adjacent — the
                           ``reorder.mars_order`` policy applied to the batch

  ``kv_read_trace``        the 64B-line address stream the paged *gather*
                           emits toward memory (per-lane streams interleaved
                           round robin)
  ``kv_read_trace_kernel`` the same step's reads as the reference's Pallas
                           grid issues them: sequence-major, each lane's
                           pages in page-table order, page-contiguously.
                           The port's K1 walks page ranges of every lane
                           at once; this is the reference's order, the
                           model the live row-hit gauge reads
                           (``obs.Observer.observe_kv_walk``)

Host-side numpy, bitwise equal to the reference.  The trace builders
accept empty inputs and return an empty int32 stream.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.reorder import mars_order
from repro_torch.core.streams import _round_robin_merge
from repro_torch.kvcache.placement import row_group_of
from repro_torch.kvcache.pool import LINES_PER_BLOCK


def pool_page_tables(tables: Sequence, pad_to: int | None = None,
                     pad_lanes: int | None = None):
    """(page_tables int32 (B, n_pages), lengths int32 (B,)).  Padding block
    id 0 is safe: the kernel masks positions >= length.  ``pad_to`` pads
    the page axis, ``pad_lanes`` the batch axis (padded lanes have
    length 0, which the kernel skips entirely)."""
    n_pages = max((len(t.blocks) for t in tables), default=1)
    n_pages = max(n_pages, pad_to or 1)
    B = max(len(tables), pad_lanes or 0)
    pt = np.zeros((B, n_pages), np.int32)
    lengths = np.zeros(B, np.int32)
    for i, t in enumerate(tables):
        pt[i, :len(t.blocks)] = t.blocks
        lengths[i] = t.num_tokens
    return pt, lengths


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def decode_step_operands(tables: Sequence, tokens: Sequence[int],
                         block_size: int):
    """Operand pack for one ragged decode step over ``tables``.

    Returns ``(page_tables (Bp, n_pages) int32, lengths (Bp,) int32,
    tokens (Bp, 1) int32)`` with both the page axis and the lane axis
    padded to the next power of two — every lane has room for its new
    slot (``num_tokens + 1``).  Padded lanes carry length 0 (the kernel
    skips them) and token 0.
    """
    B = len(tables)
    n_pages = _pow2(max(
        -(-(t.num_tokens + 1) // block_size) for t in tables))
    pt, lengths = pool_page_tables(tables, pad_to=n_pages,
                                   pad_lanes=_pow2(B))
    toks = np.zeros((pt.shape[0], 1), np.int32)
    toks[:B, 0] = list(tokens)
    return pt, lengths, toks


def batch_lane_order(tables: Sequence, blocks_per_group: int,
                     shard_ids: Sequence[int] | None = None) -> np.ndarray:
    """Permutation over batch lanes grouping tail blocks by row neighborhood
    (first-arrival page order, FIFO within a page — ``mars_order``).
    ``shard_ids``: per-lane shard of a mesh-sharded pool, the leading
    grouping coordinate."""
    if not tables:
        return np.zeros(0, np.int64)
    groups = np.asarray([
        row_group_of(t.blocks[-1], blocks_per_group) if t.blocks else -1
        for t in tables], np.int32)
    if shard_ids is not None:
        assert len(shard_ids) == len(tables)
        span = int(groups.max()) + 2        # local groups live in [-1, max]
        groups = np.asarray(shard_ids, np.int32) * span + groups
    return np.asarray(mars_order(groups))


def kv_read_trace(tables: Sequence, *, grant_beats: int = 4,
                  lines_per_block: int = LINES_PER_BLOCK) -> np.ndarray:
    """64B-line addresses of one decode step's full KV gather.

    Each lane reads its whole block list sequentially (one block = one 4KB
    page); lanes run in parallel, so the stream the memory system sees is
    the round-robin interleave of the per-lane streams — the same
    multi-stream merge that destroys locality at the paper's GPU boundary.
    """
    lanes = [_lane_lines(t, lines_per_block) for t in tables if t.blocks]
    if not lanes:
        return np.zeros(0, np.int32)
    addr, _ = _round_robin_merge(lanes, grant_beats)
    return addr


def kv_read_trace_kernel(tables: Sequence, *,
                         lines_per_block: int = LINES_PER_BLOCK,
                         window_tokens: int = 0,
                         block_size: int = 16) -> np.ndarray:
    """64B-line addresses of one decode step's KV reads as the reference's
    Pallas ``paged_attention`` grid issues them: lanes served one after
    another (grid axis 0), each lane's pages in page-table order (grid
    axis 1), lines within a page contiguous.  No cross-lane interleave
    ever reaches the memory system — the kernel-path rendering of the MARS
    reorder.

    ``window_tokens`` > 0 models the kernel's sliding-window page gate: a
    query at position ``num_tokens`` attends cached positions
    ``(num_tokens - window, num_tokens)`` only, so pages entirely outside
    the window are never fetched (the gather path has no such gate — it
    gathers the full table and masks afterwards).
    """
    chunks = [_lane_lines(t, lines_per_block,
                          window_tokens=window_tokens,
                          block_size=block_size)
              for t in tables if t.blocks]
    chunks = [c for c in chunks if c.size]
    if not chunks:
        return np.zeros(0, np.int32)
    return np.concatenate(chunks)


def _lane_lines(table, lines_per_block: int, *, window_tokens: int = 0,
                block_size: int = 16) -> np.ndarray:
    blocks = table.blocks
    if window_tokens:
        # first valid cached position for the in-flight query (canonical
        # definition: paged_attention ref._window_lo).  A window of 1
        # admits no cached position (lo == num_tokens), but the kernel's
        # clamped index map still names one in-range page per lane — the
        # pipeline DMAs it even though the body never runs — so model a
        # single residual page, not an empty trace.
        lo = table.num_tokens - window_tokens + 1
        if lo >= table.num_tokens:
            blocks = blocks[-1:]
        else:
            blocks = blocks[max(lo, 0) // block_size:]
    base = np.asarray(blocks, np.int64)[:, None] * lines_per_block
    return (base + np.arange(lines_per_block)).reshape(-1).astype(np.int32)
