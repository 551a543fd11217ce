"""Data pipeline: deterministic sharded token streams + MARS bucket buffer
(port of ``repro/data/pipeline.py``, numpy only, unchanged).

Two parts:

  * ``TokenStream`` — synthetic-corpus token batches, sharded per host
    (each data-parallel host draws a disjoint, deterministic slice; resume
    is exact from (seed, step)).  Used by examples and the train driver.

  * ``BucketReorderBuffer`` — the MARS policy applied to sample batching:
    the "page" is a length bucket; a bounded lookahead window groups
    samples by bucket (minimizing padding waste = wasted bandwidth), and
    buckets are drained oldest-first so no sample starves.  Identical
    structure to the paper's RequestQ/PhyPageOrderQ.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class TokenStream:
    """Deterministic, shardable, resumable synthetic LM data."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        # key: (seed, step, host) — exact resume, disjoint across hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + self.step) * 4096 + cfg.host_id)
        # zipf-ish marginals give the embedding gather a realistic page
        # distribution (hot rows + long tail) for the MARS gather path
        z = rng.zipf(1.3, size=(cfg.host_batch, cfg.seq_len + 1))
        tokens = (z % cfg.vocab).astype(np.int32)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        self.step += 1
        return batch


class BucketReorderBuffer:
    """MARS lookahead for variable-length samples.

    offer() inserts a sample into its length bucket (page); take_batch()
    drains the bucket holding the oldest sample — padded to that bucket's
    upper bound only, not the global max.
    """

    def __init__(self, bucket_edges=(128, 256, 512, 1024, 2048, 4096),
                 window: int = 512):
        self.edges = tuple(bucket_edges)
        self.window = window
        self.buckets: "OrderedDict[int, deque]" = OrderedDict()
        self.total = 0

    def _bucket(self, length: int) -> int:
        for i, e in enumerate(self.edges):
            if length <= e:
                return i
        return len(self.edges) - 1

    def offer(self, sample: np.ndarray) -> bool:
        if self.total >= self.window:
            return False
        b = self._bucket(len(sample))
        self.buckets.setdefault(b, deque()).append(sample)
        self.total += 1
        return True

    def take_batch(self, batch_size: int):
        """Oldest-bucket-first drain; returns (padded batch, mask)."""
        if not self.buckets:
            return None
        b = next(iter(self.buckets))
        q = self.buckets[b]
        out = [q.popleft() for _ in range(min(batch_size, len(q)))]
        if not q:
            del self.buckets[b]
        self.total -= len(out)
        width = self.edges[b]
        arr = np.zeros((len(out), width), out[0].dtype)
        mask = np.zeros((len(out), width), bool)
        for i, s in enumerate(out):
            arr[i, :len(s)] = s
            mask[i, :len(s)] = True
        return arr, mask

    def padding_waste(self, batch, mask) -> float:
        return 1.0 - mask.mean()
