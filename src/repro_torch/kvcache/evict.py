"""Eviction of cached (refcount-zero) prefix blocks.

A block whose last reference drops is not necessarily freed: if it holds a
registered prompt prefix it stays resident so a future request can reuse
it, exactly like a clean page in a page cache.  When an allocation finds
the free list short, cached blocks are reclaimed in one of two orders:

  fifo   first-arrival order of the block's allocation — the PhyPageOrderQ
         policy of the MARS engine (drain the oldest page first), which
         bounds how long any block can squat in the pool
  lru    least-recently-used, the classic comparison point
  cost   recompute-vs-refetch aware: victims are ranked by what
         re-acquiring the block would cost (cheapest first), via a
         ``cost_fn`` hook — ``kvcache.tiers.TierManager`` installs its
         scoring (0 for a clean tier copy, bytes x tier fetch cost for a
         demotable block, tokens-to-recompute x prefill cost for a drop);
         ties and an uninstalled hook fall back to LRU order
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class EvictionPolicy:
    def __init__(self, mode: str = "fifo",
                 cost_fn: Optional[Callable[[int], float]] = None):
        if mode not in ("fifo", "lru", "cost"):
            raise ValueError(f"unknown eviction mode {mode!r}")
        self.mode = mode
        # re-acquisition cost of evicting a block id now (microseconds);
        # consulted only in "cost" mode, installed post-construction by
        # whoever owns the cost model (the tier manager)
        self.cost_fn = cost_fn

    def select(self, evictable: "dict[int, None]", arrival: np.ndarray,
               last_use: np.ndarray, n: int) -> list[int]:
        """Pick ``n`` victims from the evictable id set (keys of an
        insertion-ordered dict, oldest insertion first)."""
        ids = list(evictable)
        if n >= len(ids):
            return ids
        if self.mode == "cost" and self.cost_fn is not None:
            fn = self.cost_fn
            ids.sort(key=lambda b: (fn(b), int(last_use[b]), b))
            return ids[:n]
        key = arrival if self.mode == "fifo" else last_use
        ids.sort(key=lambda b: (int(key[b]), b))
        return ids[:n]
