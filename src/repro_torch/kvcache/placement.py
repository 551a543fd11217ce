"""MARS-aware block placement (port of ``repro/kvcache/placement.py``).

In the DRAM model (``core.dram``) a 4KB page maps to one (bank, row) pair
per channel, and the ``n_banks`` consecutive pages of a *row group* span
all banks exactly once.  A decode batch interleaves KV reads from every
running sequence's tail blocks — the same multi-stream interleave that
destroys row locality at the GPU boundary in the paper.  Two interleaved
blocks in the same bank but different rows thrash the row buffer (every
switch pays PRE+ACT); two blocks in the same row group occupy *different*
banks, so their rows stay open across the interleave.

MARS-aware placement therefore packs co-scheduled sequences' blocks into
as few row groups as possible (same neighborhood, distinct banks), and
keeps a sequence's own blocks near the groups it already occupies.  The
naive baseline is the classic slab free list: LIFO pop, which after
allocation churn hands out blocks scattered across many row groups.
"""
from __future__ import annotations

from typing import Iterable, Sequence


def row_group_of(block_id: int, blocks_per_group: int) -> int:
    """DRAM-row neighborhood of a block (block == one 4KB page)."""
    return block_id // blocks_per_group


def placement_key(block_id: int, blocks_per_group: int,
                  shard: int = 0) -> tuple[int, int, int]:
    """Full MARS placement key of a block: ``(shard, row_group, block)``.

    The **leading device/shard coordinate** orders placement decisions one
    level above the bank+row-group key: with a mesh-sharded pool
    (``kvcache.sharded_pool``) a stream is first routed to a memory
    *device* (shard), then row-group-packed within it — block ids are
    shard-local, so comparing keys across shards is only meaningful with
    the shard coordinate in front.  Single-pool callers keep ``shard=0``
    and the key degenerates to the single-pool ``(group, block)`` order.
    """
    return (shard, row_group_of(block_id, blocks_per_group), block_id)


class PlacementPolicy:
    """Chooses which free blocks an allocation gets.

    Maintains the free set twice, mirroring how the MARS engine keeps both
    the RequestQ bit-vector and the per-page lists: a LIFO stack (arrival
    order of frees — the naive slab order) and per-row-group sets (the
    neighborhood index the MARS policy searches).
    """

    def __init__(self, num_blocks: int, blocks_per_group: int,
                 mode: str = "mars"):
        if mode not in ("mars", "naive"):
            raise ValueError(f"unknown placement mode {mode!r}")
        self.mode = mode
        self.num_blocks = num_blocks
        self.blocks_per_group = blocks_per_group
        self.n_groups = -(-num_blocks // blocks_per_group)
        self._stack: list[int] = list(range(num_blocks - 1, -1, -1))
        self._group_free: list[set[int]] = [
            set(range(g * blocks_per_group,
                      min((g + 1) * blocks_per_group, num_blocks)))
            for g in range(self.n_groups)]

    # -- free-set maintenance (called only by BlockPool) --------------------

    def add_free(self, bid: int) -> None:
        self._stack.append(bid)
        self._group_free[row_group_of(bid, self.blocks_per_group)].add(bid)

    def _take(self, bid: int) -> None:
        self._group_free[row_group_of(bid, self.blocks_per_group)].remove(bid)
        # lazy stack deletion would break the free invariant checks; the
        # stack is short (<= num_blocks) and removal is O(stack) worst case
        if self._stack and self._stack[-1] == bid:
            self._stack.pop()
        else:
            self._stack.remove(bid)

    @property
    def num_free(self) -> int:
        return len(self._stack)

    def free_ids(self) -> list[int]:
        return list(self._stack)

    # -- allocation order ---------------------------------------------------

    def choose(self, n: int,
               hint_groups: Iterable[int] = ()) -> list[int] | None:
        """Pick ``n`` free blocks; None if fewer than ``n`` are free."""
        if n > len(self._stack):
            return None
        if self.mode == "naive":
            out = [self._stack[-1 - i] for i in range(n)]
        else:
            out = self._choose_mars(n, hint_groups)
        for bid in out:
            self._take(bid)
        return out

    def _choose_mars(self, n: int, hint_groups: Iterable[int]) -> list[int]:
        hints = [g for g in dict.fromkeys(hint_groups)
                 if 0 <= g < self.n_groups]
        # neighborhoods the caller's gang already occupies first, then the
        # emptiest neighborhoods (pack the allocation into few row groups)
        rest = sorted((g for g in range(self.n_groups) if g not in hints),
                      key=lambda g: (-len(self._group_free[g]), g))
        out: list[int] = []
        for g in hints + rest:
            if len(out) >= n:
                break
            out.extend(sorted(self._group_free[g])[:n - len(out)])
        return out

    def groups_of(self, block_ids: Sequence[int]) -> list[int]:
        """Distinct row groups a set of blocks occupies (insertion order)."""
        return list(dict.fromkeys(
            row_group_of(b, self.blocks_per_group) for b in block_ids))
