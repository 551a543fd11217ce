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

The DRAM-trace builders (``kv_read_trace``, ``kv_read_trace_kernel``)
arrive with the observability slice.  Host-side numpy, bitwise equal to
the reference.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.reorder import mars_order
from repro_torch.kvcache.placement import row_group_of


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
