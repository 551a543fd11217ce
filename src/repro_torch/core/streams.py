"""Synthetic GPU request-stream generation + multi-level arbitration
(port of ``repro/core/streams.py``; numpy only, the same arrays).

Models the paper's Section 2 setup: N shader cores clustered into shader
core groups (SCGs); each core emits sequential per-stream requests
(texture / stencil / color / HiZ / depth regions); requests are merged by
round-robin arbitration first within each SCG and then across SCGs before
they leave the GPU.  The merged order is what the memory controller sees in
the baseline (no MARS).

Addresses are 64B-cacheline ids (int32).  A 4KB physical page = 64 lines.
All generation is deterministic (pure numpy) so experiments are exactly
reproducible.  ``kernels.paged_attention.ops.kv_read_trace`` merges its
per-lane streams with ``_round_robin_merge``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

LINE_BYTES = 64
PAGE_BYTES = 4096
LINES_PER_PAGE = PAGE_BYTES // LINE_BYTES  # 64
PAGE_SHIFT = 6  # line-id -> page-id


@dataclasses.dataclass(frozen=True)
class RequestStream:
    """A merged stream of memory requests at some observation point."""

    addr: np.ndarray      # int32[N]  64B-line ids
    is_write: np.ndarray  # bool[N]
    source: np.ndarray    # int32[N]  emitting core id

    def __post_init__(self):
        assert self.addr.shape == self.is_write.shape == self.source.shape

    @property
    def n(self) -> int:
        return int(self.addr.shape[0])

    @property
    def page(self) -> np.ndarray:
        return self.addr >> PAGE_SHIFT


@dataclasses.dataclass(frozen=True)
class GpuConfig:
    """Shader-core topology (paper Section 2 / Section 4).

    ``grant_beats``: consecutive beats an arbiter grants one source before
    rotating (real NOC arbiters grant per packet/burst, so short same-source
    runs survive the merge — this is why the baseline MC is not fully
    pathological).
    """

    n_cores: int = 64
    cores_per_group: int = 8
    grant_beats: int = 7
    # consecutive requests a core issues from one of its sub-streams before
    # switching (stream-specific L1s emit misses in per-page bursts as a
    # texture/stencil tile is walked, not one line at a time)
    substream_chunk: int = 8

    @property
    def n_groups(self) -> int:
        return self.n_cores // self.cores_per_group


# ---------------------------------------------------------------------------
# Per-core stream generation
# ---------------------------------------------------------------------------

def _core_stream(base_page: int, n_req: int, *, stride: int = 1,
                 rng: np.random.Generator | None = None,
                 jitter: float = 0.0) -> np.ndarray:
    """Sequential line addresses starting at ``base_page`` with optional
    small jitter (models partially out-of-order misses from a texture cache).
    """
    addr = base_page * LINES_PER_PAGE + np.arange(n_req, dtype=np.int64) * stride
    if jitter > 0.0 and rng is not None:
        noise = rng.integers(0, max(1, int(jitter * LINES_PER_PAGE)), size=n_req)
        addr = addr + noise
    return addr.astype(np.int32)


def _round_robin_merge(streams: Sequence[np.ndarray],
                       grant_beats: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Round-robin arbitration across equal-rate sources, granting
    ``grant_beats`` consecutive beats per source per rotation.

    Returns merged array + source-id array.  Streams may have unequal
    lengths; exhausted streams drop out of the rotation (as a real arbiter
    would skip empty input queues).
    """
    lens = [len(s) for s in streams]
    total = sum(lens)
    out = np.empty(total, dtype=np.int32)
    src = np.empty(total, dtype=np.int32)
    cursors = [0] * len(streams)
    pos = 0
    while pos < total:
        for i, s in enumerate(streams):
            take = min(grant_beats, lens[i] - cursors[i])
            if take > 0:
                out[pos:pos + take] = s[cursors[i]:cursors[i] + take]
                src[pos:pos + take] = i
                cursors[i] += take
                pos += take
    return out, src


def merge_hierarchical(core_streams: Sequence[np.ndarray],
                       core_writes: Sequence[np.ndarray],
                       cfg: GpuConfig) -> RequestStream:
    """Two-level round-robin: within SCG, then across SCGs.

    This is the arbitration that destroys per-stream locality (paper Fig 2).
    """
    n = len(core_streams)
    g = cfg.cores_per_group
    gb = cfg.grant_beats
    group_addr, group_src, group_wr = [], [], []
    for g0 in range(0, n, g):
        a, s = _round_robin_merge(core_streams[g0:g0 + g], gb)
        w, _ = _round_robin_merge(core_writes[g0:g0 + g], gb)
        group_addr.append(a)
        group_src.append(s + g0)
        group_wr.append(w)
    merged_addr, gsel = _round_robin_merge(group_addr, gb)
    merged_wr, _ = _round_robin_merge(group_wr, gb)
    # recover source ids through the same rotation
    merged_src = np.empty_like(merged_addr)
    cursors = [0] * len(group_src)
    for i, gi in enumerate(gsel):
        merged_src[i] = group_src[gi][cursors[gi]]
        cursors[gi] += 1
    return RequestStream(merged_addr, merged_wr.astype(bool), merged_src)


# ---------------------------------------------------------------------------
# Paper workloads (Table 1)
# ---------------------------------------------------------------------------

_STREAM_REGION_PAGES = 1 << 14  # 64MB region per logical graphics stream


def _build(cfg: GpuConfig, reqs_per_core: int, specs, seed: int) -> RequestStream:
    """specs: list of (region_id, is_write, fraction, stride) sub-streams."""
    rng = np.random.default_rng(seed)
    core_streams, core_writes = [], []
    for c in range(cfg.n_cores):
        parts_a, parts_w = [], []
        for (region, wr, frac, stride) in specs:
            n_req = int(reqs_per_core * frac)
            # Each core walks its own slice of the stream's region — this is
            # the "inherent locality in a single data stream" at source.
            # Slice bases get a small randomized offset (real allocators
            # don't place per-core surface slices at perfectly regular
            # strides), which avoids systematic bank aliasing.
            span = reqs_per_core * stride // LINES_PER_PAGE + 2
            base_page = (region * _STREAM_REGION_PAGES + c * (span + 2)
                         + int(rng.integers(0, 2)))
            parts_a.append(_core_stream(base_page, n_req, stride=stride,
                                        rng=rng, jitter=0.05))
            parts_w.append(np.full(n_req, wr, dtype=np.int32))
        if len(parts_a) == 1:
            a, w = parts_a[0], parts_w[0]
        else:
            # a core interleaves its own sub-streams (e.g. stencil read +
            # color write) in tile-sized chunks
            a, _ = _round_robin_merge(parts_a, cfg.substream_chunk)
            w, _ = _round_robin_merge(parts_w, cfg.substream_chunk)
        core_streams.append(a)
        core_writes.append(w)
    return merge_hierarchical(core_streams, core_writes, cfg)


def make_workload(name: str, cfg: GpuConfig | None = None,
                  reqs_per_core: int = 512, seed: int = 0) -> RequestStream:
    """The five synthetic memory-intensive workloads of Table 1."""
    cfg = cfg or GpuConfig()
    wl = {
        # WL1: read only, single texture stream
        "WL1": [(0, 0, 1.0, 1)],
        # WL2: read + write, stencil and color streams
        "WL2": [(1, 0, 0.5, 1), (2, 1, 0.5, 1)],
        # WL3: write only, single stream
        "WL3": [(3, 1, 1.0, 1)],
        # WL4: read only, HiZ and depth streams
        "WL4": [(4, 0, 0.5, 1), (5, 0, 0.5, 1)],
        # WL5: read + write, single HiZ stream (read-modify-write same tile)
        "WL5": [(6, 0, 0.5, 1), (6, 1, 0.5, 1)],
    }
    if name not in wl:
        raise ValueError(f"unknown workload {name!r}; have {sorted(wl)}")
    return _build(cfg, reqs_per_core, wl[name], seed)


WORKLOADS = ("WL1", "WL2", "WL3", "WL4", "WL5")


# ---------------------------------------------------------------------------
# Locality metric (paper Fig 2)
# ---------------------------------------------------------------------------

def locality(addr: np.ndarray, window: int) -> float:
    """Average #requests per unique 4KB page within consecutive windows."""
    pages = (np.asarray(addr, dtype=np.int64) >> PAGE_SHIFT)
    n = (len(pages) // window) * window
    if n == 0:
        return float(len(pages)) / max(1, len(np.unique(pages)))
    w = pages[:n].reshape(-1, window)
    w = np.sort(w, axis=1)
    uniq = 1 + (np.diff(w, axis=1) != 0).sum(axis=1)
    return float((window / uniq).mean())


def locality_sweep(addr: np.ndarray,
                   windows=(128, 512, 2048, 8192, 16384)) -> dict[int, float]:
    return {w: locality(addr, w) for w in windows if w <= len(addr)}


def single_cache_stream(cfg: GpuConfig | None = None, reqs_per_core: int = 2048,
                        seed: int = 0) -> np.ndarray:
    """The texture stream at the output of ONE L1 texture cache (pre-merge)."""
    cfg = cfg or GpuConfig()
    rng = np.random.default_rng(seed)
    return _core_stream(0, reqs_per_core, rng=rng, jitter=0.05)
