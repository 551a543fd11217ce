"""Unified KV-backend API: dense and paged serving caches, one interface
(port of ``repro/kvcache/backend.py``; the dense backend serves every
ported family, the paged ones the dense, hybrid and MoE families).

The model (``models.lm``) speaks to its KV storage only through
``KVBackend``: ``prefill`` runs a prompt batch and stores every layer's
K/V, ``decode_step`` advances every lane one token.  Three
implementations:

  DenseBackend   the concrete per-layer ``lm.Cache`` on the device.
  PagedBackend   per-sequence block tables over a layered ``BlockPool``
                 (one block id addresses a token-chunk's KV for every
                 layer), ragged continuous-batching decode, prefix
                 sharing and copy-on-write forks — what ``serve.engine``
                 drives.  A hybrid model's per-sequence SSM state and
                 conv context live beside the block tables, as tensors
                 on the backend's device.  ``tiered=True`` puts spill
                 tiers behind the pool (``kvcache.tiers``): eviction
                 demotes registered prefix blocks, prefix misses that
                 hit a tier promote them back.
  ShardedPagedBackend  one complete ``PagedBackend`` per shard of a
                 ``kvcache.sharded_pool.ShardedBlockPool`` (own pool,
                 prefix cache, tiers, mirror pair and device — on one GPU
                 every shard's device is the same card): the kernels run
                 per shard over shard-local page tables, sequences never
                 span shards.

Decode through the paged backend has two modes (``decode_mode``):

  "kernel"   the default: ``lm.paged_decode_step`` reads each layer's KV
             straight from the staged pool through ``paged_attention`` —
             the Hopper kernel on a CUDA device, its plain twin on the
             CPU (the device decides; nothing falls back).
  "gather"   the oracle: gather each lane's pages into a dense per-layer
             view and run ``lm.dense_decode_step``.

The new token's K/V is written back into the host pool after attention,
so the kernel never reads a partially-written page.  The host pool is
staged to the device through two mirror slots (double buffering) that
re-upload only the blocks dirtied since that slot was last staged
(``BlockPool.drain_dirty``), with ``index_copy_`` along the block axis.

Decode is split-phase:

    step = backend.dispatch_decode(params, tokens, sids=...)  # launch
    logits = backend.sync(step)        # block on logits only
    ...                                # sample / emit while KV is in flight
    backend.flush()                    # commit the deferred KV write-back

``dispatch_decode`` enqueues the step's device work and returns without
blocking the host (operands cross from pinned buffers asynchronously;
only a backend's first stage, which builds the mirrors, waits); ``sync``
blocks on the logits and starts the non-blocking device->host copy of the
new K/V into pinned buffers behind a CUDA event; ``commit`` (normally via
``flush`` or the next ``dispatch_decode``) waits on that event and
appends the K/V to the pool one step late.  Every path that could observe
or allocate pool state — ``new_seq``/``prefill``, ``fork_seq``,
``pause_seq``/``resume_seq``, ``free_seq``, ``release`` — flushes first.

Construction goes through ``make_backend``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Protocol, Sequence, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kvcache.pool import BlockPool, PoolConfig
from repro_torch.kvcache.prefix import BlockTable, PrefixCache
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DecodeStep:
    """Handle for one in-flight decode step.

    ``dispatch_decode`` returns one; ``sync(step)`` fills ``logits`` and
    flips ``synced``; ``commit(step)`` (or ``flush()``, or the next
    ``dispatch_decode``) lands the deferred KV write-back and flips
    ``committed``.  ``dev`` holds backend-internal in-flight tensors and
    ``parts`` the per-shard inner steps of a sharded dispatch.
    """
    index: int                       # per-backend dispatch counter
    sids: list                       # sequences this step advances
    tokens: list                     # tokens[i] fed to sids[i]
    staged: int = 0                  # mirror blocks staged at dispatch
    synced: bool = False
    committed: bool = False
    batch_api: bool = False          # dispatched via the (B, 1) batch API
    logits: Any = None               # host logits after sync
    dev: dict = dataclasses.field(default_factory=dict)
    seqs: Optional[list] = None      # resolved _PagedSeq refs
    on_alloc: Optional[Callable[[int, int], None]] = None
    parts: Optional[list] = None     # sharded: (shard, inner step, idxs)


@runtime_checkable
class KVBackend(Protocol):
    """What the model needs from its KV storage — nothing more.  Decode
    is split-phase (``dispatch_decode`` -> ``sync`` -> ``commit``,
    ``flush()`` the barrier); ``decode_step`` is the synchronous
    wrapper over the three phases."""

    cfg: ModelConfig

    def prefill(self, params, tokens, frontend_emb=None):
        """Run a (B, S) prompt batch, store every layer's K/V; returns
        last-position logits (B, 1, V).  An encoder-decoder model's
        encoder reads ``frontend_emb`` (dense backend only)."""
        ...

    def decode_step(self, params, tokens):
        """Advance every prefill lane one token (tokens (B, 1)); returns
        next-token logits (B, 1, V)."""
        ...

    def dispatch_decode(self, params, tokens, *, sids=None,
                        on_alloc=None) -> DecodeStep:
        """Launch one decode step without blocking on its results."""
        ...

    def sync(self, step: DecodeStep):
        """Block on a dispatched step's logits (KV write-back deferred)."""
        ...

    def commit(self, step: Optional[DecodeStep] = None) -> None:
        """Land the pending synced step's KV write-back."""
        ...

    def flush(self) -> None:
        """Barrier: sync any in-flight step, commit any pending one."""
        ...

    @property
    def lengths(self) -> np.ndarray:
        """Per-lane cached token counts, int32 (B,)."""
        ...

    def release(self) -> None:
        """Drain pending write-back, then drop all storage; later entry
        points raise "backend released"."""
        ...


def _tokens_on(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(tokens, np.int32)).to(device)


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without blocking the host: on CUDA
    through a pinned copy and an asynchronous upload (the caching host
    allocator keeps the pinned copy alive until the upload is done)."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Dense backend
# ---------------------------------------------------------------------------

class DenseBackend:
    """The concrete ``lm.Cache`` behind the backend interface: K/V where
    the model has attention, SSM state where it has an SSM, and an
    encoder-decoder model's cross-attention K/V over ``enc_len``
    frames."""

    def __init__(self, cfg: ModelConfig, batch: int, max_seq: int,
                 enc_len: int = 0, device="cuda"):
        from repro_torch.models import lm
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self._cache = lm.init_dense_cache(cfg, batch, max_seq, self.device,
                                          enc_len=enc_len)
        self._steps = 0

    def _check_released(self) -> None:
        if self._cache is None:
            raise RuntimeError(
                "DenseBackend released: release() dropped the cache "
                "storage; build a new backend to serve again")

    def prefill(self, params, tokens, frontend_emb=None):
        """Dense prompt run into a fresh cache sized ``max_seq``.  tokens:
        (B, S) int with B == ``self.batch``; ``frontend_emb`` (B, Senc, d)
        feeds an encoder-decoder model's encoder.  Returns (B, 1, V)."""
        from repro_torch.models import lm
        self._check_released()
        if frontend_emb is not None:
            frontend_emb = frontend_emb.to(self.device)
        logits, self._cache = lm.dense_prefill(
            params, self.cfg, _tokens_on(tokens, self.device), self.max_seq,
            frontend_emb)
        return logits

    def decode_step(self, params, tokens):
        step = self.dispatch_decode(params, tokens)
        logits = self.sync(step)
        self.commit(step)
        return logits

    # The dense cache is written inside the step, so "dispatch" already
    # carries the write-back: sync marks the step committed and
    # commit/flush are no-ops.

    def dispatch_decode(self, params, tokens, *, sids=None,
                        on_alloc=None) -> DecodeStep:
        from repro_torch.models import lm
        self._check_released()
        if sids is not None:
            raise ValueError("DenseBackend has no sequence-level lanes; "
                             "dispatch with sids=None (the (B, 1) batch)")
        logits, self._cache = lm.dense_decode_step(
            params, self.cfg, _tokens_on(tokens, self.device), self._cache)
        step = DecodeStep(index=self._steps, sids=[], tokens=[],
                          batch_api=True)
        step.dev["logits"] = logits
        self._steps += 1
        return step

    def sync(self, step: DecodeStep):
        if not step.synced:
            step.logits = step.dev.pop("logits")
            step.synced = step.committed = True
        return step.logits

    def commit(self, step: Optional[DecodeStep] = None) -> None:
        """No deferred write-back exists on the dense path."""

    def flush(self) -> None:
        self._check_released()

    @property
    def inflight_steps(self) -> int:
        return 0

    @property
    def lengths(self) -> np.ndarray:
        self._check_released()
        ln = np.asarray(self._cache.length.cpu(), np.int32)
        return np.broadcast_to(np.atleast_1d(ln), (self.batch,)).copy()

    def release(self) -> None:
        self._cache = None

    @property
    def cache(self):
        return self._cache


# ---------------------------------------------------------------------------
# Paged backend
# ---------------------------------------------------------------------------

def _paged_decode_gather(params, cfg, tokens, k_pages, v_pages, page_tables,
                         lengths, ssm=None, conv=None):
    """Gather each lane's pages into a dense per-layer view, run the ragged
    dense decode step, and extract the new token's K/V for write-back.
    ssm/conv: hybrid side state (L, B, H, P, N) / (L, B, k-1, ch), or
    None.  Returns (logits, k_new (L, B, 1, K, dh), v_new, ssm_new,
    conv_new)."""
    from repro_torch.models import lm
    L = k_pages.shape[0]
    K, dh = k_pages.shape[-2:]
    B = tokens.shape[0]
    idx = page_tables.long()
    k = k_pages[:, idx].reshape(L, B, -1, K, dh)
    v = v_pages[:, idx].reshape(L, B, -1, K, dh)
    logits, new = lm.dense_decode_step(params, cfg, tokens,
                                       lm.Cache(k, v, lengths, ssm, conv))
    rows = torch.arange(B, device=k.device)
    pos = lengths.long()
    return (logits, new.k[:, rows, pos][:, :, None],
            new.v[:, rows, pos][:, :, None], new.ssm, new.conv)


def _clone(t):
    return None if t is None else t.clone()


@dataclasses.dataclass
class _PagedSeq:
    sid: int
    table: BlockTable
    tokens: list            # tokens whose KV is cached
    # hybrid side state the pool cannot hold: the SSM recurrent state
    # (L, H, P, N) float32 and the conv trailing context (L, k-1, ch), on
    # the backend's device (no host round trip per step), cloned on
    # fork and pause, freed with the sequence
    ssm: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None


class PagedBackend:
    """Per-sequence block tables over a layered ``BlockPool``.

    Sequence-level API (what the serve engine drives): ``new_seq`` /
    ``fork_seq`` / ``decode`` / ``pause_seq`` / ``resume_seq`` /
    ``free_seq``.  The batch-level ``KVBackend`` API (``prefill`` /
    ``decode_step``) runs the same machinery over a fixed batch.

    Prompt K/V is always recomputed; prefix sharing is at the storage
    level — matched blocks are referenced instead of re-allocated.
    """

    def __init__(self, cfg: ModelConfig, *, pool: Optional[BlockPool] = None,
                 num_blocks: int = 256, block_size: int = 16,
                 placement: str = "mars", eviction: str = "fifo",
                 share_prefixes: bool = True, decode_mode: str = "kernel",
                 device="cuda", tiered: bool = False, tier_specs=None):
        """Build a paged backend over ``pool`` (or a fresh pool sized by
        ``num_blocks``/``block_size`` matching the model config).

        Args:
          cfg: a dense-, hybrid- or MoE-family model config (the pool
            holds one plane per layer across an MoE model's two block
            stacks).
          pool: existing layered ``BlockPool`` to share; its KV buffer
            shape must match ``cfg``.
          placement/eviction: pool policies when building a fresh pool
            ("cost" eviction pairs with ``tiered``: the tier manager
            installs its recompute-vs-refetch scoring hook).
          share_prefixes: storage-level prefix sharing via ``PrefixCache``.
          decode_mode: "kernel" (``paged_attention`` per layer, the
            default) or "gather" (dense-view oracle).
          device: where the staged KV mirror and the decode run; a CUDA
            device pins the pool's host buffers.
          tiered: put host / mock-remote spill tiers behind the pool
            (``kvcache.tiers.TierManager``): eviction demotes registered
            prefix blocks instead of dropping them, and prefix misses
            that hit a lower tier promote them back through a
            MARS-reordered batched copy-in.  Requires prefix sharing.
          tier_specs: ``TierSpec`` sequence overriding
            ``tiers.default_tiers``.
        """
        from repro_torch.models import lm
        lm.check_paged_family(cfg)   # dense, MoE, or hybrid (+ SSM state)
        if decode_mode not in ("kernel", "gather"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        self.decode_mode = decode_mode
        self.device = resolve_device(device)
        self.cfg = cfg
        if pool is None:
            pool = BlockPool(PoolConfig(
                num_blocks=num_blocks, block_size=block_size,
                placement=placement, eviction=eviction,
                n_kv_heads=cfg.n_kv_heads, head_dim=cfg.d_head,
                n_layers=cfg.n_layers, dtype=cfg.kv_dtype_name))
        assert pool.k_pages is not None, "paged backend needs a KV pool"
        assert pool.cfg.n_layers == cfg.n_layers \
            and pool.cfg.n_kv_heads == cfg.n_kv_heads \
            and pool.cfg.head_dim == cfg.d_head, \
            "pool KV buffer does not match the model config"
        if self.device.type == "cuda":
            pool.pin_memory()
        self.pool = pool
        self.prefix = PrefixCache(pool.cfg.block_size)
        if share_prefixes:
            self.prefix.attach(pool)
        self.share_prefixes = share_prefixes
        # spill tiers: the manager interposes on pool.on_evict AFTER
        # prefix.attach, so demotion captures the payload before the
        # prefix cache unregisters the block
        self.tiers = None
        if tiered:
            assert share_prefixes, \
                "tiered KV spills registered prefix blocks; enable " \
                "share_prefixes"
            from repro_torch.kvcache.tiers import TierManager
            self.tiers = TierManager(pool, self.prefix, tier_specs)
        self._seqs: dict[int, _PagedSeq] = {}
        self._next_sid = 0
        self._batch: list[int] = []      # batch-level API lane order
        self._released = False
        # telemetry (obs.Observer.attach): spans + the modelled row-
        # locality feed; obs_shard tags events with this backend's shard
        self.obs = None
        self.obs_shard = 0
        # double-buffered device mirrors of the pool's KV buffers: two
        # (k, v) slots, swapped every stage, each with its own pending-
        # dirty set (both fed from pool.drain_dirty — this backend is the
        # pool's single drain_dirty consumer)
        self._mirrors: list = [None, None]
        self._slot_dirty: list = [set(), set()]
        self._slot = 0                   # slot the next stage writes
        self._staged_slot: Optional[int] = None  # slot staged last
        self.staged_blocks_last_step = 0
        # split-phase decode: at most one dispatched-un-synced step
        # (_inflight) and one synced-un-committed step (_pending)
        self._inflight: Optional[DecodeStep] = None
        self._pending: Optional[DecodeStep] = None
        self._steps = 0

    def _check_released(self) -> None:
        if self._released:
            raise RuntimeError(
                "PagedBackend released: release() returned every block "
                "to the pool; build a new backend to serve again")

    # -- device staging ------------------------------------------------------

    def _upload_blocks(self, mirror: torch.Tensor, host: torch.Tensor,
                       blocks: list) -> None:
        """Copy host pool planes ``blocks`` into a device mirror along the
        block axis.  On CUDA the gathered planes land in a fresh pinned
        buffer and cross asynchronously (the caching host allocator keeps
        it alive until the copy is done), so the host never waits."""
        idx = torch.as_tensor(blocks, dtype=torch.long)
        shape = (host.shape[0], len(blocks)) + tuple(host.shape[2:])
        cuda = self.device.type == "cuda"
        vals = torch.empty(shape, dtype=host.dtype, pin_memory=cuda)
        torch.index_select(host, 1, idx, out=vals)
        if host.dtype == torch.float8_e4m3fn:
            # index_copy_ has no float8 kernel: copy the same bytes
            mirror, vals = mirror.view(torch.uint8), vals.view(torch.uint8)
        mirror.index_copy_(1, _upload(idx, self.device),
                           vals.to(self.device, non_blocking=cuda))

    def _staged_pages(self):
        """Stage the pool's host-mutated KV buffers into the next mirror
        slot, uploading only blocks written since *that slot* was last
        staged (both slots are built with a full upload the first time).
        ``staged_blocks_last_step`` records how many blocks moved.
        Returns the freshly staged ``(k, v)`` device pair."""
        pool = self.pool
        if self._mirrors[0] is None:
            pool.drain_dirty()           # full upload covers everything
            for s in (0, 1):
                self._mirrors[s] = (pool.k_pages.to(self.device, copy=True),
                                    pool.v_pages.to(self.device, copy=True))
                self._slot_dirty[s].clear()
            self.staged_blocks_last_step = pool.cfg.num_blocks
            self._staged_slot, self._slot = 0, 1
        else:
            fresh = pool.drain_dirty()
            self._slot_dirty[0].update(fresh)
            self._slot_dirty[1].update(fresh)
            s = self._slot
            pend = sorted(self._slot_dirty[s])
            self.staged_blocks_last_step = len(pend)
            if pend:
                k, v = self._mirrors[s]
                self._upload_blocks(k, pool.k_pages, pend)
                self._upload_blocks(v, pool.v_pages, pend)
            self._slot_dirty[s].clear()
            self._staged_slot, self._slot = s, 1 - s
        if self.obs is not None:
            self.obs.trace.event("backend.stage", shard=self.obs_shard,
                                 blocks=self.staged_blocks_last_step,
                                 slot=self._staged_slot)
        return self._mirrors[self._staged_slot]

    # -- sequence-level API (continuous batching) ---------------------------

    def new_seq(self, params, prompt: Sequence[int],
                on_alloc: Optional[Callable[[int, int], None]] = None
                ) -> tuple[int, Any, int]:
        """Prefill one sequence into the pool.  Returns (sid,
        last-position logits (V,) float32 numpy, shared-prefix tokens).
        Atomic under pool exhaustion (see ``_add_seqs``)."""
        logits, sids, shared = self._add_seqs(
            params, np.asarray([list(prompt)], np.int32), on_alloc)
        return sids[0], logits[0], shared[0]

    def _add_seqs(self, params, tokens: np.ndarray,
                  on_alloc=None) -> tuple[Any, list[int], list[int]]:
        """Batched prompt prefill -> one new sequence per row.  Atomic
        under pool exhaustion: on RuntimeError every partial table and
        every row this call added is released, then the error
        re-raises."""
        self._check_released()
        # flush barrier: prefill allocates, and the prefix match reads
        # refcounts/tokens — both must see the deferred step committed
        self.flush()
        if self.obs is not None:
            with self.obs.trace.span("backend.prefill",
                                     shard=self.obs_shard,
                                     rows=int(tokens.shape[0])) as sp:
                out = self._add_seqs_impl(params, tokens, on_alloc)
                sp["shared_tokens"] = int(sum(out[2]))
                return out
        return self._add_seqs_impl(params, tokens, on_alloc)

    def _add_seqs_impl(self, params, tokens: np.ndarray,
                       on_alloc=None) -> tuple[Any, list[int], list[int]]:
        from repro_torch.models import lm
        B, S = tokens.shape
        logits, parts = lm.prefill_parts(params, self.cfg,
                                         _tokens_on(tokens, self.device))
        kvd = self.cfg.kvdtype
        k_all = parts["k"].to(kvd).cpu()     # (L, B, S, K, dh)
        v_all = parts["v"].to(kvd).cpu()
        ssm_all, conv_all = parts["ssm"], parts["conv"]   # None if dense
        sids, shared = [], []
        for b in range(B):
            prompt = [int(t) for t in tokens[b]]
            bids, n = self._match(prompt)
            table = BlockTable(list(bids), n)
            allocs0 = self.pool.stats.allocs
            try:
                table.extend(
                    self.pool, prompt[n:], seq_tokens=prompt,
                    cache=self.prefix if self.share_prefixes else None,
                    kv=(k_all[:, b, n:], v_all[:, b, n:]))
            except RuntimeError:
                # roll back: queued promotions first (their destination
                # blocks are released with the tables below; the tier
                # entries were never removed), then this row's partial
                # table, then the rows this call already created
                if self.tiers is not None:
                    self.tiers.cancel_promotions()
                self.prefix.release(table, self.pool)
                for sid in sids:
                    self.free_seq(sid)
                raise
            sid = self._next_sid
            self._next_sid += 1
            seq = _PagedSeq(sid, table, list(prompt))
            if ssm_all is not None:
                seq.ssm = ssm_all[:, b].clone()
                seq.conv = conv_all[:, b].clone()
            self._seqs[sid] = seq
            if on_alloc is not None:
                on_alloc(sid, self.pool.stats.allocs - allocs0)
            sids.append(sid)
            shared.append(n)
        if self.tiers is not None:
            # the whole batch's promotions land in one MARS-reordered
            # copy-in; the dirtied blocks stage to the device mirror
            # before the next decode step reads them
            self.tiers.flush_promotions()
        return logits[:, 0].float().cpu().numpy(), sids, shared

    def _match(self, prompt) -> tuple[list[int], int]:
        """The prompt's reusable full-block prefix: none without prefix
        sharing; through the tiers (in-pool chain, then promotable
        lower-tier blocks, queued for ``flush_promotions``) when tiered;
        else the prefix cache."""
        if not self.share_prefixes:
            return [], 0
        if self.tiers is not None:
            return self.tiers.match(prompt)
        return self.prefix.match(prompt, self.pool)

    def fork_seq(self, sid: int) -> int:
        """Fork a sequence, sharing every block (CoW on first append); the
        hybrid side state is cloned — it advances every step.  Flushes
        first: the fork's CoW bookkeeping (and its side state) must see
        the committed step."""
        self._check_released()
        self.flush()
        src = self._seqs[sid]
        nsid = self._next_sid
        self._next_sid += 1
        self._seqs[nsid] = _PagedSeq(nsid, src.table.fork(self.pool),
                                     list(src.tokens), ssm=_clone(src.ssm),
                                     conv=_clone(src.conv))
        return nsid

    # -- decode preemption (pause -> resume) ---------------------------------

    def pause_seq(self, sid: int) -> dict:
        """Preempt a live decode: flush first, capture the sequence's
        decode state (cached tokens, every block's KV payload + content
        tag host-side, a copy of the hybrid side state on the device),
        then release its blocks (registered prefix blocks stay as
        evictable cache, demotable to the spill tiers under pressure).
        Returns the record ``resume_seq`` restores from, bitwise."""
        self._check_released()
        self.flush()
        if self.obs is not None:
            self.obs.trace.event("backend.pause", shard=self.obs_shard,
                                 sid=sid)
        seq = self._seqs.pop(sid)
        pool = self.pool
        blocks = [{"content": pool.content[bid],
                   "k": pool.k_pages[:, bid].clone(),
                   "v": pool.v_pages[:, bid].clone()}
                  for bid in seq.table.blocks]
        rec = {"tokens": list(seq.tokens),
               "num_tokens": seq.table.num_tokens,
               "blocks": blocks,
               "ssm": _clone(seq.ssm), "conv": _clone(seq.conv)}
        self.prefix.release(seq.table, pool)
        return rec

    def resume_seq(self, rec: dict,
                   on_alloc: Optional[Callable[[int, int], None]] = None
                   ) -> int:
        """Re-admit a paused sequence bitwise-identically under a new sid:
        leading blocks re-enter through the prefix cache and the tiers
        (the same bytes: demotion captured them verbatim), the rest are
        restored from the record's captured pages.  Atomic under pool
        exhaustion."""
        self._check_released()
        self.flush()
        if self.obs is not None:
            self.obs.trace.event("backend.resume", shard=self.obs_shard,
                                 tokens=len(rec["tokens"]))
        pool = self.pool
        bs = pool.cfg.block_size
        tokens = list(rec["tokens"])
        num = rec["num_tokens"]
        bids, n = self._match(tokens)
        # the on_alloc claim counts only the restore's own allocations
        # (promotion destinations are the tier manager's)
        allocs0 = pool.stats.allocs
        start = n // bs
        need = len(rec["blocks"]) - start
        try:
            if not pool.can_alloc(need):
                raise RuntimeError(
                    f"pool exhausted: resume needs {need} blocks, "
                    f"free {pool.num_free}, cached {pool.num_cached}")
            fresh = pool.alloc(need, hint_blocks=bids) if need else []
        except RuntimeError:
            if self.tiers is not None:
                self.tiers.cancel_promotions()
            self.prefix.release(BlockTable(list(bids), n), pool)
            raise
        for j, bid in enumerate(fresh):
            src = rec["blocks"][start + j]
            pool.content[bid] = src["content"]
            pool.write_kv(bid, 0, src["k"], src["v"])
            pool.touch(bid)
            end = (start + j + 1) * bs
            if self.share_prefixes and end <= num:
                self.prefix.register(tuple(tokens[:end]), bid, pool)
        if self.tiers is not None:
            self.tiers.flush_promotions()
        sid = self._next_sid
        self._next_sid += 1
        self._seqs[sid] = _PagedSeq(
            sid, BlockTable(list(bids) + list(fresh), num), tokens,
            ssm=_clone(rec["ssm"]), conv=_clone(rec["conv"]))
        if on_alloc is not None:
            on_alloc(sid, pool.stats.allocs - allocs0)
        return sid

    def decode(self, params, sids: Sequence[int], tokens: Sequence[int],
               on_alloc: Optional[Callable[[int, int], None]] = None):
        """One ragged decode step over live sequences, synchronously
        (``dispatch_decode`` + ``sync`` + ``commit``).  Returns float32
        (len(sids), V) numpy logits row-aligned to sids."""
        step = self.dispatch_decode(params, tokens, sids=sids,
                                    on_alloc=on_alloc)
        out = self.sync(step)
        self.commit(step)
        return out

    # -- split-phase decode lifecycle ----------------------------------------

    def dispatch_decode(self, params, tokens, *, sids=None,
                        on_alloc: Optional[Callable[[int, int], None]]
                        = None) -> DecodeStep:
        """Launch one ragged decode step without blocking.

        Commits the pending prior step first, prechecks capacity for this
        step (each lane needs at most one fresh block: a new tail or a
        CoW copy), stages the next mirror slot, and enqueues the step's
        device work without blocking the host.  ``sids=None`` dispatches
        the batch-API lanes (``tokens`` is the (B, 1) batch).  Raising
        leaves every sequence exactly as it was.
        """
        from repro_torch.kernels.paged_attention import ops
        from repro_torch.models import lm
        self._check_released()
        batch_api = sids is None
        if batch_api:
            sids = list(self._batch)
            tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        assert sids, "no active sequences to decode (prefill first)"
        if self._inflight is not None:
            raise RuntimeError(
                "a decode step is already in flight; sync() it before "
                "dispatching the next")
        self._commit_pending()
        # tier contract: every queued promotion is flushed (copied in and
        # dirtied for staging) before a promoted page can enter a decode
        # batch — prefill and resume flush theirs, so the queue is empty
        assert self.tiers is None or self.tiers.pending == 0, \
            "unflushed tier promotions entering a decode batch"
        seqs = [self._seqs[s] for s in sids]
        page = self.pool.cfg.block_size
        need = 0
        for s in seqs:
            fill = s.table.num_tokens % page
            if fill == 0 or \
                    self.pool.refcount[s.table.blocks[-1]] > 1:
                need += 1
        if not self.pool.can_alloc(need):
            raise RuntimeError(
                f"pool exhausted: decode step needs {need} blocks, "
                f"free {self.pool.num_free}, cached {self.pool.num_cached}")
        pt, lengths, toks = ops.decode_step_operands(
            [s.table for s in seqs], tokens, page)
        kp, vp = self._staged_pages()
        if self.obs is not None:
            # modelled row locality: this step's page walk in the
            # reference kernel's grid order (sequence-major, page-
            # contiguous), from the host block tables, fed to this
            # shard's open-row model
            self.obs.observe_kv_walk(
                self.obs_shard,
                ops.kv_read_trace_kernel([s.table for s in seqs],
                                         block_size=page))
        dev = self.device
        pt_d = _upload(torch.from_numpy(pt), dev)
        len_d = _upload(torch.from_numpy(lengths), dev)
        toks_d = _upload(torch.from_numpy(toks), dev)
        ssm = conv = None
        if self.cfg.has_ssm:
            # batch the per-sequence side state along a lane axis; padded
            # lanes get zeros (their outputs are dropped at commit)
            ssm = _lanes([s.ssm for s in seqs], toks.shape[0])
            conv = _lanes([s.conv for s in seqs], toks.shape[0])
        if self.decode_mode == "kernel":
            logits, k_new, v_new, ssm_new, conv_new = lm.paged_decode_step(
                params, self.cfg, toks_d, kp, vp, pt_d, len_d,
                ssm_state=ssm, conv_state=conv)
        else:
            logits, k_new, v_new, ssm_new, conv_new = _paged_decode_gather(
                params, self.cfg, toks_d, kp, vp, pt_d, len_d, ssm, conv)
        step = DecodeStep(index=self._steps, sids=list(sids),
                          tokens=[int(t) for t in tokens],
                          staged=self.staged_blocks_last_step,
                          batch_api=batch_api, seqs=seqs,
                          on_alloc=on_alloc)
        step.dev.update(logits=logits, k=k_new, v=v_new, ssm=ssm_new,
                        conv=conv_new)
        self._steps += 1
        self._inflight = step
        if self.obs is not None:
            self.obs.trace.event("backend.dispatch", shard=self.obs_shard,
                                 step=step.index, lanes=len(seqs),
                                 staged=step.staged)
        return step

    def sync(self, step: DecodeStep):
        """Block on a dispatched step's logits.  The new K/V then starts
        its non-blocking device->host copy into pinned buffers (a CUDA
        event marks its end); the write-back commits one step later.
        Idempotent.  Returns float32 (len(sids), V) numpy logits, or a
        (B, 1, V) tensor for a batch-API step."""
        self._check_released()
        if step.synced:
            return step.logits
        if step is not self._inflight:
            raise RuntimeError(
                "sync() of a step that is not in flight on this backend")
        B = len(step.sids)
        if self.obs is not None:
            # the span measures the blocking wait on the host — on a CUDA
            # device, where the step's device work becomes visible
            with self.obs.trace.span("backend.decode",
                                     shard=self.obs_shard,
                                     step=step.index, lanes=B) as sp:
                sp["staged"] = step.staged
                step.logits = step.dev.pop("logits")[:B, 0].float() \
                    .cpu().numpy()
        else:
            step.logits = step.dev.pop("logits")[:B, 0].float().cpu().numpy()
        if self.device.type == "cuda":
            for name in ("k", "v"):
                d = step.dev[name]
                h = torch.empty(d.shape, dtype=d.dtype, pin_memory=True)
                h.copy_(d, non_blocking=True)
                step.dev[name] = h
            ev = torch.cuda.Event()
            ev.record()
            step.dev["kv_ready"] = ev
        if step.batch_api:
            step.logits = torch.from_numpy(step.logits)[:, None, :] \
                .to(self.device)
        step.synced = True
        self._inflight = None
        self._pending = step
        return step.logits

    def commit(self, step: Optional[DecodeStep] = None) -> None:
        """Land the pending synced step's KV write-back.  ``step=None``
        commits whatever is pending; a committed step is a no-op; an
        un-synced step is an error."""
        self._check_released()
        if step is not None:
            if step.committed:
                return
            if step is not self._pending:
                raise RuntimeError(
                    "commit() of a step that is not pending on this "
                    "backend (sync() it first)")
        self._commit_pending()

    def _commit_pending(self) -> None:
        """The deferred write-back: wait for the step's K/V copy, append
        it to each lane's block table (CoW on shared tails), advance each
        lane's hybrid side state (a view of the step's device output),
        fire ``on_alloc``.  Cannot fail: capacity was prechecked at dispatch
        and every alloc/refcount path since has flushed first."""
        step = self._pending
        if step is None:
            return
        self._pending = None
        ev = step.dev.pop("kv_ready", None)
        if ev is not None:
            ev.synchronize()
        k_new = step.dev.pop("k")   # (L, Bp, 1, K, dh), on the host
        v_new = step.dev.pop("v")
        ssm_new = step.dev.pop("ssm")           # (L, Bp, H, P, N) or None
        conv_new = step.dev.pop("conv")
        for i, (s, tok) in enumerate(zip(step.seqs, step.tokens)):
            allocs0 = self.pool.stats.allocs
            new_tokens = s.tokens + [int(tok)]
            s.table.extend(
                self.pool, [int(tok)], seq_tokens=new_tokens,
                cache=self.prefix if self.share_prefixes else None,
                kv=(k_new[:, i], v_new[:, i]))
            s.tokens = new_tokens     # commit only after the extend
            if ssm_new is not None:
                s.ssm, s.conv = ssm_new[:, i], conv_new[:, i]
            if step.on_alloc is not None:
                step.on_alloc(s.sid, self.pool.stats.allocs - allocs0)
        step.committed = True
        step.seqs = None
        if self.obs is not None:
            self.obs.trace.event("backend.commit", shard=self.obs_shard,
                                 step=step.index, lanes=len(step.sids))

    def flush(self) -> None:
        """Barrier: sync any in-flight step and commit any pending
        write-back.  Idempotent."""
        self._check_released()
        if self._inflight is not None:
            self.sync(self._inflight)
        self._commit_pending()

    @property
    def inflight_steps(self) -> int:
        """Steps between dispatch and commit: 0, 1 or 2."""
        return int(self._inflight is not None) + \
            int(self._pending is not None)

    def free_seq(self, sid: int) -> None:
        """Finished sequence: registered prefix blocks stay evictable.
        Flushes first — the deferred step may still owe it a token."""
        self._check_released()
        self.flush()
        seq = self._seqs.pop(sid)
        self.prefix.release(seq.table, self.pool)

    def table(self, sid: int) -> BlockTable:
        self._check_released()
        return self._seqs[sid].table

    def block_of(self, sid: int, layer: int, token_index: int) -> int:
        """Pool block holding a token's KV for one layer — the layer axis
        shares the block id, so one placement covers all layers."""
        assert 0 <= layer < self.cfg.n_layers
        seq = self._seqs[sid]
        assert token_index < seq.table.num_tokens
        return seq.table.blocks[token_index // self.pool.cfg.block_size]

    # -- batch-level KVBackend API ------------------------------------------

    def prefill(self, params, tokens, frontend_emb=None):
        """Protocol ``prefill``: one new sequence per row of the (B, S)
        batch, freeing any lanes a prior call created.  Returns
        last-position logits (B, 1, V) on the backend's device."""
        self._check_released()
        self.flush()
        if frontend_emb is not None:
            raise ValueError("the paged backend keeps no frontend state "
                             "(encoder-decoder models serve densely)")
        old, self._batch = self._batch, []
        for sid in old:
            self.free_seq(sid)
        logits, self._batch, _ = self._add_seqs(
            params, np.asarray(tokens, np.int32))
        return torch.from_numpy(logits)[:, None, :].to(self.device)

    def decode_step(self, params, tokens):
        """Protocol ``decode_step``: advance the prefill lanes one token.
        Returns next-token logits (B, 1, V) on the backend's device."""
        self._check_released()
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        logits = self.decode(params, self._batch, toks)
        return torch.from_numpy(logits)[:, None, :].to(self.device)

    @property
    def lengths(self) -> np.ndarray:
        self._check_released()
        return np.asarray(
            [self._seqs[s].table.num_tokens for s in self._batch], np.int32)

    def release(self) -> None:
        """Drain the decode pipeline, free every live sequence, drop the
        mirror slots, and poison the backend."""
        if not self._released:
            if self._inflight is not None:
                self.sync(self._inflight)
            self._commit_pending()
        for sid in list(self._seqs):
            self.free_seq(sid)
        self._batch = []
        self._mirrors = [None, None]
        self._slot_dirty = [set(), set()]
        self._slot, self._staged_slot = 0, None
        self._released = True


def _lanes(states: list, n_lanes: int) -> torch.Tensor:
    """Per-sequence (L, ...) side states -> one (L, n_lanes, ...) batch,
    zero-padded past ``len(states)``."""
    out = torch.stack(states, dim=1)
    pad = n_lanes - len(states)
    if pad:
        out = torch.cat([out, out.new_zeros(
            (out.shape[0], pad) + tuple(out.shape[2:]))], dim=1)
    return out


# ---------------------------------------------------------------------------
# Mesh-sharded paged backend
# ---------------------------------------------------------------------------

class ShardedPagedBackend:
    """One ``PagedBackend`` per shard of a ``ShardedBlockPool``.

    Each shard owns a complete serving stack: its own block pool, prefix
    cache, spill tiers (``tiered=``), staged-dirty mirror pair and
    ``device`` (on one GPU every shard's is the same card), so
    ``lm.paged_decode_step`` runs the kernels per shard over shard-local
    pools.  A sequence lives entirely on one shard: ``fork_seq`` forks
    within the parent's shard and prefix sharing only matches blocks the
    same shard stored — which is why the scheduler routes shared
    prefixes to one shard.

    Sequence ids handed out here are backend-global; the mapping to
    (shard, inner sid) is internal.  ``decode`` accepts any mix of
    sequences, groups them by shard, runs one ragged step per shard (all
    dispatched before any is synced), and reassembles logits in call
    order.  The batch-level ``KVBackend`` API routes prefill rows to the
    least-loaded shard.
    """

    def __init__(self, cfg: ModelConfig, *, pool=None,
                 n_shards: Optional[int] = None, mesh=None,
                 devices: Optional[Sequence] = None,
                 num_blocks: int = 256, block_size: int = 16,
                 placement: str = "mars", eviction: str = "fifo", **kw):
        """Prefer ``make_backend(cfg, "paged", shards=N, ...)``.

        Args:
          pool: a ``ShardedBlockPool`` to drive, or None to build one
            (``num_blocks`` total across shards, rounded up to a multiple
            of the shard count).
          n_shards/mesh: shard-count discovery when building the pool —
            forwarded to ``ShardedBlockPool`` (mesh model axis; 1
            without a mesh).
          devices: per-shard devices for the mirrors and the decode
            (length ``n_shards``; entries may repeat when fewer devices
            than shards exist).  None puts every shard on "cuda".
          Remaining kwargs (decode_mode, share_prefixes, tiered,
          tier_specs) configure every per-shard backend alike.
        """
        from repro_torch.kvcache.sharded_pool import ShardedBlockPool, \
            discover_shards
        if pool is None:
            n_shards = discover_shards(n_shards, mesh)
            num_blocks = -(-num_blocks // n_shards) * n_shards
            pool = ShardedBlockPool(
                PoolConfig(num_blocks=num_blocks, block_size=block_size,
                           placement=placement, eviction=eviction,
                           n_kv_heads=cfg.n_kv_heads, head_dim=cfg.d_head,
                           n_layers=cfg.n_layers, dtype=cfg.kv_dtype_name),
                n_shards=n_shards, mesh=mesh)
        assert isinstance(pool, ShardedBlockPool), \
            "ShardedPagedBackend needs a ShardedBlockPool"
        if devices is None:
            devices = ["cuda"] * pool.n_shards
        assert len(devices) == pool.n_shards, (len(devices), pool.n_shards)
        self.cfg = cfg
        self.pool = pool
        self.backends = [PagedBackend(cfg, pool=shard_pool, device=devices[i],
                                      **kw)
                         for i, shard_pool in enumerate(pool.shards)]
        self._seqs: dict[int, tuple[int, int]] = {}   # gsid -> (shard, isid)
        self._rev: dict[tuple[int, int], int] = {}    # (shard, isid) -> gsid
        self._next_sid = 0
        self._batch: list[int] = []
        self._released = False
        # split-phase state (as PagedBackend's; the per-shard inner steps
        # live in the outer step's ``parts``)
        self._inflight: Optional[DecodeStep] = None
        self._pending: Optional[DecodeStep] = None
        self._steps = 0

    def _check_released(self) -> None:
        if self._released:
            raise RuntimeError(
                "ShardedPagedBackend released: release() returned every "
                "block to its shard pool; build a new backend to serve "
                "again")

    # decode_mode and staging reads mirror PagedBackend's so the engine's
    # use_kernel override stays backend-agnostic (the setter fans out)

    @property
    def decode_mode(self) -> str:
        return self.backends[0].decode_mode

    @decode_mode.setter
    def decode_mode(self, mode: str) -> None:
        if mode not in ("kernel", "gather"):
            raise ValueError(f"unknown decode_mode {mode!r}")
        for b in self.backends:
            b.decode_mode = mode

    @property
    def device(self) -> torch.device:
        """The first shard's device: where batch-API logits land."""
        return self.backends[0].device

    @property
    def staged_blocks_last_step(self) -> int:
        return sum(b.staged_blocks_last_step for b in self.backends)

    # -- sequence-level API (what the serve engine drives) ------------------

    def _new_sid(self) -> int:
        gsid = self._next_sid
        self._next_sid += 1
        return gsid

    def _adopt(self, gsid: int, shard: int, isid: int) -> int:
        """Map backend-global ``gsid`` to shard ``shard``'s ``isid``."""
        self._seqs[gsid] = (shard, isid)
        self._rev[(shard, isid)] = gsid
        return gsid

    def new_seq(self, params, prompt: Sequence[int],
                on_alloc: Optional[Callable[[int, int], None]] = None,
                shard: Optional[int] = None) -> tuple[int, Any, int]:
        """Prefill one sequence on one shard: ``shard`` is the routed
        shard (what ``MarsScheduler`` stamped on the request), None the
        least-loaded one.  Returns as ``PagedBackend.new_seq``; every
        block of the sequence lives in ``pool.shards[shard]``."""
        self._check_released()
        # barrier across all shards (the inner new_seq flushes its own)
        self.flush()
        if shard is None:
            shard = self.pool.least_loaded()
        assert 0 <= shard < self.pool.n_shards, shard
        gsid = self._new_sid()
        cb = None if on_alloc is None else \
            (lambda _isid, n: on_alloc(gsid, n))
        isid, logits, shared = self.backends[shard].new_seq(
            params, prompt, on_alloc=cb)
        self._adopt(gsid, shard, isid)
        return gsid, logits, shared

    def fork_seq(self, sid: int) -> int:
        """Fork within the parent's shard (CoW is shard-local); flushes
        every shard first."""
        self._check_released()
        self.flush()
        shard, isid = self._seqs[sid]
        nisid = self.backends[shard].fork_seq(isid)
        return self._adopt(self._new_sid(), shard, nisid)

    def pause_seq(self, sid: int) -> dict:
        """Preempt a live decode on its shard (``PagedBackend.pause_seq``)
        after a barrier across every shard.  The record remembers the
        shard, so an un-routed resume goes back to where the cached and
        demoted blocks live."""
        self._check_released()
        self.flush()
        shard, isid = self._seqs.pop(sid)
        del self._rev[(shard, isid)]
        rec = self.backends[shard].pause_seq(isid)
        rec["shard"] = shard
        return rec

    def resume_seq(self, rec: dict,
                   on_alloc: Optional[Callable[[int, int], None]] = None,
                   shard: Optional[int] = None) -> int:
        """Re-admit a paused sequence under a new global sid: on the pause
        shard by default (prefix and tier matches only hit there), or on
        ``shard`` (the captured payload is restored there).  Bitwise
        either way."""
        self._check_released()
        self.flush()
        if shard is None:
            shard = rec.get("shard", self.pool.least_loaded())
        assert 0 <= shard < self.pool.n_shards, shard
        gsid = self._new_sid()
        cb = None if on_alloc is None else \
            (lambda _isid, n: on_alloc(gsid, n))
        isid = self.backends[shard].resume_seq(rec, on_alloc=cb)
        return self._adopt(gsid, shard, isid)

    def decode(self, params, sids: Sequence[int], tokens: Sequence[int],
               on_alloc: Optional[Callable[[int, int], None]] = None):
        """One ragged decode round across shards, synchronously
        (``dispatch_decode`` + ``sync`` + ``commit``).  All-or-nothing
        across shards.  Returns float32 (len(sids), V) numpy logits
        row-aligned to sids."""
        step = self.dispatch_decode(params, tokens, sids=sids,
                                    on_alloc=on_alloc)
        out = self.sync(step)
        self.commit(step)
        return out

    # -- split-phase decode lifecycle (issue-then-gather) --------------------

    def dispatch_decode(self, params, tokens, *, sids=None,
                        on_alloc: Optional[Callable[[int, int], None]]
                        = None) -> DecodeStep:
        """Dispatch one decode round on every involved shard before any
        is synced: commit the prior round everywhere, run the cross-shard
        capacity precheck (so a raise leaves every shard as it was), then
        enqueue each shard's step back to back — none blocks the host, so
        the shards' mirror uploads and kernels queue up on the device."""
        self._check_released()
        batch_api = sids is None
        if batch_api:
            sids = list(self._batch)
            tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        assert sids, "no active sequences to decode (prefill first)"
        if self._inflight is not None:
            raise RuntimeError(
                "a decode step is already in flight; sync() it before "
                "dispatching the next")
        self._commit_pending()
        by_shard: dict[int, list[int]] = {}
        for i, s in enumerate(sids):
            by_shard.setdefault(self._seqs[s][0], []).append(i)
        # cross-shard capacity precheck (the per-shard one, for every
        # shard before any dispatches): each lane needs at most one fresh
        # block — a new tail, or a CoW copy of a shared tail
        page = self.pool.cfg.block_size
        for shard, idxs in by_shard.items():
            inner = self.backends[shard]
            need = 0
            for i in idxs:
                t = inner._seqs[self._seqs[sids[i]][1]].table
                fill = t.num_tokens % page
                if fill == 0 or inner.pool.refcount[t.blocks[-1]] > 1:
                    need += 1
            if not inner.pool.can_alloc(need):
                raise RuntimeError(
                    f"pool exhausted on shard {shard}: decode step needs "
                    f"{need} blocks, free {inner.pool.num_free}, "
                    f"cached {inner.pool.num_cached}")
        parts = []
        for shard, idxs in sorted(by_shard.items()):
            cb = None if on_alloc is None else \
                functools.partial(self._on_alloc, on_alloc, shard)
            inner_step = self.backends[shard].dispatch_decode(
                params, [tokens[i] for i in idxs],
                sids=[self._seqs[sids[i]][1] for i in idxs], on_alloc=cb)
            parts.append((shard, inner_step, idxs))
        step = DecodeStep(index=self._steps, sids=list(sids),
                          tokens=[int(t) for t in tokens],
                          staged=self.staged_blocks_last_step,
                          batch_api=batch_api, parts=parts)
        self._steps += 1
        self._inflight = step
        return step

    def _on_alloc(self, on_alloc, shard: int, isid: int, n: int) -> None:
        on_alloc(self._rev[(shard, isid)], n)

    def sync(self, step: DecodeStep):
        """Gather every shard's logits (every shard's step was already
        enqueued) and reassemble rows in call order.  Idempotent."""
        self._check_released()
        if step.synced:
            return step.logits
        if step is not self._inflight:
            raise RuntimeError(
                "sync() of a step that is not in flight on this backend")
        rows: dict[int, np.ndarray] = {}
        for shard, inner_step, idxs in step.parts:
            lg = self.backends[shard].sync(inner_step)
            for j, i in enumerate(idxs):
                rows[i] = lg[j]
        step.logits = np.stack([rows[i] for i in range(len(step.sids))])
        if step.batch_api:
            step.logits = torch.from_numpy(step.logits)[:, None, :] \
                .to(self.device)
        step.synced = True
        self._inflight = None
        self._pending = step
        return step.logits

    def commit(self, step: Optional[DecodeStep] = None) -> None:
        """Commit every shard's part of the pending round."""
        self._check_released()
        if step is not None:
            if step.committed:
                return
            if step is not self._pending:
                raise RuntimeError(
                    "commit() of a step that is not pending on this "
                    "backend (sync() it first)")
        self._commit_pending()

    def _commit_pending(self) -> None:
        step = self._pending
        if step is None:
            return
        self._pending = None
        for shard, inner_step, _ in step.parts:
            self.backends[shard].commit(inner_step)
        step.committed = True

    def flush(self) -> None:
        """Barrier across every shard: sync the in-flight round, commit
        the pending one, and drain each shard backend.  Idempotent."""
        self._check_released()
        if self._inflight is not None:
            self.sync(self._inflight)
        self._commit_pending()
        for b in self.backends:
            b.flush()

    @property
    def inflight_steps(self) -> int:
        """Cross-shard rounds between dispatch and commit (0, 1 or 2)."""
        return int(self._inflight is not None) + \
            int(self._pending is not None)

    def free_seq(self, sid: int) -> None:
        """Release a finished sequence to its shard's pool (after the
        flush barrier)."""
        self._check_released()
        self.flush()
        shard, isid = self._seqs.pop(sid)
        del self._rev[(shard, isid)]
        self.backends[shard].free_seq(isid)

    def table(self, sid: int) -> BlockTable:
        self._check_released()
        shard, isid = self._seqs[sid]
        return self.backends[shard].table(isid)

    def shard_of(self, sid: int) -> int:
        """Shard a live sequence's blocks occupy — the leading coordinate
        of its placement key (``placement.placement_key``)."""
        self._check_released()
        return self._seqs[sid][0]

    # -- tiered KV memory (per-shard tiers, shard-local) ---------------------

    @property
    def tiered(self) -> bool:
        """True iff the per-shard backends carry spill tiers (one
        ``TierManager`` per shard pool: payloads never cross shards)."""
        return self.backends[0].tiers is not None

    def tier_shard_for(self, prompt: Sequence[int]) -> Optional[int]:
        """Shard whose spill tiers hold the prompt's first full prefix
        block, or None — the lower-tier hit ``MarsScheduler.tier_probe``
        counts toward routing, turning a recompute into a shard-local
        promotion."""
        self._check_released()
        for i, b in enumerate(self.backends):
            if b.tiers is not None and b.tiers.holds_prefix(prompt):
                return i
        return None

    # -- batch-level KVBackend API ------------------------------------------

    def prefill(self, params, tokens, frontend_emb=None):
        """Protocol ``prefill``: rows route greedily to the least-loaded
        shard (each row charged its block need), then each shard
        prefills its rows in one batched call.  Atomic across shards: if
        a later shard exhausts its pool, rows already prefilled on
        earlier shards are freed before the error re-raises.  Returns
        last-position logits (B, 1, V) in row order."""
        from repro_torch.obs.observer import shard_load_snapshot
        self._check_released()
        if frontend_emb is not None:
            raise ValueError("the paged backend keeps no frontend state "
                             "(encoder-decoder models serve densely)")
        self.flush()
        old, self._batch = self._batch, []
        for sid in old:
            self.free_seq(sid)
        tokens = np.asarray(tokens, np.int32)
        B = tokens.shape[0]
        row_blocks = -(-tokens.shape[1] // self.pool.cfg.block_size)
        load = [r["load"] for r in shard_load_snapshot(self.pool)]
        plan: dict[int, list[int]] = {}
        for i in range(B):
            s = min(range(self.pool.n_shards), key=lambda x: (load[x], x))
            plan.setdefault(s, []).append(i)
            load[s] += row_blocks
        out = np.zeros((B, self.cfg.vocab), np.float32)
        gsids: dict[int, int] = {}
        for shard, idxs in sorted(plan.items()):
            try:
                lg, isids, _ = self.backends[shard]._add_seqs(
                    params, tokens[idxs])
            except RuntimeError:
                # the failing shard rolled itself back; free the rows
                # earlier shards already created
                for gsid in gsids.values():
                    self.free_seq(gsid)
                raise
            for j, i in enumerate(idxs):
                out[i] = lg[j]
                gsids[i] = self._adopt(self._new_sid(), shard, isids[j])
        self._batch = [gsids[i] for i in range(B)]
        return torch.from_numpy(out)[:, None, :].to(self.device)

    def decode_step(self, params, tokens):
        """Protocol ``decode_step`` over the prefill lanes; lanes decode
        on their own shards.  Returns next-token logits (B, 1, V)."""
        self._check_released()
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        logits = self.decode(params, self._batch, toks)
        return torch.from_numpy(logits)[:, None, :].to(self.device)

    @property
    def lengths(self) -> np.ndarray:
        self._check_released()
        return np.asarray([self.table(s).num_tokens for s in self._batch],
                          np.int32)

    def release(self) -> None:
        """Drain the pipeline, then release every shard backend; later
        entry points raise."""
        if not self._released:
            if self._inflight is not None:
                self.sync(self._inflight)
            self._commit_pending()
        for b in self.backends:
            b.release()
        self._seqs.clear()
        self._rev.clear()
        self._batch = []
        self._released = True


def make_backend(cfg: ModelConfig, kind: str = "dense", *,
                 batch: int = 1, max_seq: int = 0, enc_len: int = 0,
                 pool=None, shards: Optional[int] = None, device=None,
                 **kw) -> KVBackend:
    """Backend registry: "dense" | "paged" | "sharded-paged".

    ``batch``/``max_seq`` are the capacity request — dense allocates
    (B, max_seq) (and an encoder-decoder model's cross-attention K/V
    over ``enc_len`` frames); paged kinds size the pool to hold
    ``batch`` lanes of ``max_seq`` tokens (+1 decode slot each) unless
    ``num_blocks`` or an explicit ``pool`` overrides it — a sharded pool
    to hold whole lanes on every shard.  ``shards > 1`` turns "paged"
    into "sharded-paged" (``n_shards`` there).  ``device`` (default
    "cuda") places a dense or paged backend; sharded kinds take per-shard
    ``devices=[...]`` and refuse ``device=``.  Remaining kwargs
    (``decode_mode``, ``block_size``, ``tiered``, ...) forward to the
    backend.
    """
    if kind == "dense":
        return DenseBackend(cfg, batch, max_seq, enc_len,
                            device="cuda" if device is None else device)
    if kind not in ("paged", "sharded-paged"):
        raise ValueError(f"unknown KV backend kind {kind!r}")
    if shards is not None and kind == "paged" and shards > 1:
        kind = "sharded-paged"
    if kind == "sharded-paged" and shards is not None:
        kw.setdefault("n_shards", shards)
    size_request = pool is None and "num_blocks" not in kw and max_seq
    bs = kw.get("block_size", 16)
    lane_blocks = -(-(max_seq + 1) // bs)
    if kind == "paged":
        if size_request:
            kw["num_blocks"] = batch * lane_blocks
        return PagedBackend(cfg, pool=pool,
                            device="cuda" if device is None else device,
                            **kw)
    if device is not None:
        raise ValueError(
            "sharded-paged takes per-shard devices=[...], not device=")
    if size_request:
        from repro_torch.kvcache.sharded_pool import discover_shards
        n = kw["n_shards"] = discover_shards(kw.get("n_shards"),
                                             kw.get("mesh"))
        # a lane never spans shards: every shard holds its share of
        # WHOLE lanes
        kw["num_blocks"] = n * (-(-batch // n)) * lane_blocks
    return ShardedPagedBackend(cfg, pool=pool, **kw)
