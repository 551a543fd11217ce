"""Ref-counted prefix sharing: block tables, prefix cache, copy-on-write
(port of ``repro/kvcache/prefix.py``).

Requests whose prompts share a prefix share the physical blocks that hold
it (the serving rendering of the paper's "physical page": many streams,
one row).  Sharing is at full-block granularity via an exact-prefix map;
forked sequences (parallel sampling) additionally share their *partial*
tail block, which makes appends hit the copy-on-write path: a shared
block is never written in place — the writer gets a fresh block, the
payload is copied, and the old block's refcount drops by one.

Full blocks register in the ``PrefixCache`` keyed by the exact token
prefix they complete; when their last reference drops they linger in the
pool as evictable cached blocks until memory pressure reclaims them
(``kvcache.evict``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.kvcache.pool import BlockPool


@dataclasses.dataclass
class BlockTable:
    """Per-sequence ordered list of pool block ids + logical token count."""

    blocks: list[int] = dataclasses.field(default_factory=list)
    num_tokens: int = 0

    def tail_room(self, block_size: int) -> int:
        return -self.num_tokens % block_size

    def fork(self, pool: BlockPool) -> "BlockTable":
        """Share every block (including a partial tail) with a new table."""
        for bid in self.blocks:
            pool.incref(bid)
        return BlockTable(list(self.blocks), self.num_tokens)

    def extend(self, pool: BlockPool, tokens: Sequence[int], *,
               seq_tokens: Sequence[int],
               cache: Optional["PrefixCache"] = None,
               kv=None) -> None:
        """Append ``tokens`` (the new suffix of ``seq_tokens``), allocating
        and copy-on-writing blocks as needed.

        ``kv``: optional (k, v) arrays of shape (len(tokens), Hkv, D) —
        or (n_layers, len(tokens), Hkv, D) for a layered pool — to store
        into the pool's KV buffer alongside the token tags.
        """
        bs = pool.cfg.block_size
        assert len(seq_tokens) == self.num_tokens + len(tokens)
        done = 0
        while done < len(tokens):
            fill = self.num_tokens % bs
            if fill == 0:
                bid = pool.alloc(1, hint_blocks=self.blocks)[0]
                self.blocks.append(bid)
            else:
                bid = self.blocks[-1]
                if pool.refcount[bid] > 1:        # copy-on-write
                    new = pool.alloc(1, hint_blocks=self.blocks)[0]
                    pool.copy_block(bid, new)
                    pool.decref(bid)
                    bid = self.blocks[-1] = new
            take = min(bs - fill, len(tokens) - done)
            chunk = tuple(tokens[done:done + take])
            prev = pool.content[bid] or ()
            assert len(prev) == fill, (prev, fill)
            pool.content[bid] = prev + chunk
            if kv is not None:
                k, v = kv
                # token axis is -3 for both layerless and layered shapes
                pool.write_kv(bid, fill, k[..., done:done + take, :, :],
                              v[..., done:done + take, :, :])
            pool.touch(bid)
            self.num_tokens += take
            done += take
            if cache is not None and self.num_tokens % bs == 0:
                cache.register(tuple(seq_tokens[:self.num_tokens]), bid, pool)


class PrefixCache:
    """Exact-prefix map: full-block token prefixes -> pool block id."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._by_key: dict[tuple, int] = {}
        self._by_bid: dict[int, tuple] = {}

    def attach(self, pool: BlockPool) -> None:
        pool.on_evict = self.on_evict

    # -- lookup -------------------------------------------------------------

    def match(self, prompt: Sequence[int],
              pool: BlockPool) -> tuple[list[int], int]:
        """Longest chain of cached full blocks covering a prompt prefix.

        Matched blocks are referenced (revived from the evictable set if
        needed) before returning, so they cannot be evicted out from under
        the caller.  Never matches the *whole* prompt — the last token must
        be recomputed so the sequence has a writable tail position.
        """
        bs = self.block_size
        bids: list[int] = []
        n = 0
        while n + bs < len(prompt):
            key = tuple(prompt[:n + bs])
            bid = self._by_key.get(key)
            if bid is None:
                break
            assert pool.content[bid] == key[n:], "prefix cache corrupt"
            if pool.refcount[bid] == 0:
                pool.reuse_cached(bid)
            else:
                pool.incref(bid)
                pool.stats.prefix_hits += 1
            bids.append(bid)
            n += bs
        return bids, n

    # -- registration / teardown ---------------------------------------------

    def register(self, prefix: tuple, bid: int, pool: BlockPool) -> None:
        """Publish a just-completed full block; first writer wins (a later
        identical prefix keeps its private copy unregistered)."""
        if prefix in self._by_key or bid in self._by_bid:
            return
        self._by_key[prefix] = bid
        self._by_bid[bid] = prefix

    def on_evict(self, bid: int) -> None:
        key = self._by_bid.pop(bid, None)
        if key is not None:
            del self._by_key[key]

    def is_registered(self, bid: int) -> bool:
        return bid in self._by_bid

    def release(self, table: BlockTable, pool: BlockPool) -> None:
        """Drop a finished sequence's references; registered blocks stay
        resident as evictable cache, private ones free immediately."""
        for bid in table.blocks:
            pool.decref(bid, cache=self.is_registered(bid))
        table.blocks = []
        table.num_tokens = 0

    def __len__(self) -> int:
        return len(self._by_key)
