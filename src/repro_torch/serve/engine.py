"""Continuous-batching serve engine over the paged KV-cache pool (port of
``repro/serve/engine.py``; a single pool or a ``ShardedBlockPool`` served
through ``ShardedPagedBackend``).

The loop ties the MARS serving stack together, one step per call:

  admit    pop page-coherent batches from the ``MarsScheduler`` (which
           admits against pool capacity) into free decode lanes
  prefill  match the prompt against the prefix cache (ref-counted shared
           blocks), allocate the rest MARS-placed, write prompt KV
  decode   one token for every running lane; appends copy-on-write when a
           forked lane shares its tail block
  free     finished lanes release references; registered prefix blocks
           stay resident as evictable cache

Two model drivers:

  ``ToyModel``   deterministic single-layer attention LM (fixed random
                 tables) decoded inline through ``paged_attention`` (or
                 its oracle ``paged_attention_ref``).
  ``PagedLM``    a real ``ModelConfig`` model decoded through
                 ``kvcache.backend.PagedBackend`` (or
                 ``ShardedPagedBackend``); greedy sampling plus a
                 per-fork salt so parallel samples diverge.

The LM decode round drives the backend's split-phase pipeline by default
(``flush -> dispatch_decode -> sync``); ``pipeline=False`` uses the
synchronous ``decode()`` wrapper.  Served tokens are identical either way.

With an ``obs.Observer`` attached (``engine.obs``) the engine traces
admit, prefill, pause, resume, token and free events, times each step
into ``engine.step_ms`` and each pipelined decode round's three phases
into ``engine.commit_ms`` (flush), ``engine.dispatch_ms`` and
``engine.sync_ms``, all on the host clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kvcache.pool import BlockPool
from repro_torch.kvcache.prefix import BlockTable, PrefixCache
from repro_torch.obs.metrics import StatGroup
from repro_torch.serving.scheduler import MarsScheduler, Request


class ToyModel:
    """Single-layer attention LM with frozen random tables (deterministic,
    numpy: the same tables as the reference's for the same seed)."""

    def __init__(self, vocab: int = 128, n_heads: int = 4,
                 n_kv_heads: int = 2, head_dim: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab, self.n_heads = vocab, n_heads
        self.n_kv_heads, self.head_dim = n_kv_heads, head_dim
        s = 1.0 / np.sqrt(head_dim)
        self.emb_q = rng.normal(0, s, (vocab, n_heads, head_dim)).astype(np.float32)
        self.emb_k = rng.normal(0, s, (vocab, n_kv_heads, head_dim)).astype(np.float32)
        self.emb_v = rng.normal(0, s, (vocab, n_kv_heads, head_dim)).astype(np.float32)
        self.w_out = rng.normal(0, s, (n_heads * head_dim, vocab)).astype(np.float32)

    def kv_for(self, tokens):
        t = np.asarray(tokens, np.int64) % self.vocab
        return self.emb_k[t], self.emb_v[t]

    def q_for(self, tokens):
        return self.emb_q[np.asarray(tokens, np.int64) % self.vocab]

    def readout(self, o, salt):
        """attention out (B, H, D) + per-lane salt -> next tokens (B,)."""
        logits = np.asarray(o).reshape(len(o), -1) @ self.w_out
        return (np.argmax(logits, -1) + np.asarray(salt)) % self.vocab


class PagedLM:
    """A real LM for the engine: (params, cfg) served through a
    PagedBackend or a ShardedPagedBackend."""

    def __init__(self, params, cfg, backend):
        from repro_torch.kvcache.backend import PagedBackend, \
            ShardedPagedBackend
        assert isinstance(backend, (PagedBackend, ShardedPagedBackend))
        self.params = params
        self.cfg = cfg
        self.backend = backend

    def next_token(self, logits, salt: int) -> int:
        """Greedy + per-fork salt (parallel samples diverge like ToyModel)."""
        return (int(np.argmax(np.asarray(logits, np.float32))) + salt) \
            % self.cfg.vocab


def make_paged_lm(params, cfg, pool: Optional[BlockPool] = None,
                  **backend_kw) -> PagedLM:
    from repro_torch.kvcache.backend import PagedBackend
    return PagedLM(params, cfg, PagedBackend(cfg, pool=pool, **backend_kw))


@dataclasses.dataclass
class SeqState:
    rid: int
    tokens: list                 # prompt + generated
    table: BlockTable
    max_new: int
    salt: int = 0                # distinguishes forked samples
    n_generated: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    sid: int = -1                # PagedBackend sequence id (PagedLM driver)
    pending: Optional[int] = None  # first token, produced by prefill logits
    traffic_class: str = "default"  # scheduler stream (preemption policy)
    page: str = ""               # prefix-page key (re-routing on resume)

    @property
    def done(self) -> bool:
        return self.n_generated >= self.max_new


class EngineStats(StatGroup):
    """Engine counters (``obs.metrics.StatGroup`` facade)."""
    FIELDS = {"steps": 0, "prefills": 0,
              "prefill_tokens": 0,        # prompt tokens run through prefill
              "decode_tokens": 0,         # generated tokens
              "shared_prompt_tokens": 0}


class ServeEngine:
    def __init__(self, pool: BlockPool, scheduler: MarsScheduler,
                 model: Optional[Union[ToyModel, PagedLM]] = None, *,
                 max_lanes: int = 8, use_kernel: Optional[bool] = None,
                 pipeline: bool = True, device=None):
        """``use_kernel``: ToyModel — decode inline through
        ``paged_attention`` instead of its oracle (default oracle).
        PagedLM — override the backend's ``decode_mode``
        ("kernel"/"gather"); ``None`` leaves the backend as configured.

        ``pipeline``: PagedLM decode drives the split-phase backend
        lifecycle; ``False`` uses the synchronous ``decode()`` wrapper.

        ``device``: where the ToyModel's inline attention runs (default
        "cuda"); a PagedLM runs on its backend's device, which ``device``
        must match when given."""
        assert pool.k_pages is not None, "engine needs a pool with KV buffers"
        self.pool = pool
        self.scheduler = scheduler
        # mesh-sharded pools: reservations are per routed request and the
        # lane order leads with the shard of each lane's blocks
        self._sharded = bool(getattr(pool, "is_sharded", False))
        if isinstance(model, PagedLM):
            assert model.backend.pool is pool, \
                "PagedLM backend must share the engine's pool"
            if device is not None and \
                    resolve_device(device) != model.backend.device:
                raise ValueError(
                    f"engine device {device!r} differs from the backend's "
                    f"{model.backend.device}")
            if use_kernel is not None:
                model.backend.decode_mode = \
                    "kernel" if use_kernel else "gather"
            self.model = model
            self.cache = getattr(model.backend, "prefix", None)
            self.use_kernel = model.backend.decode_mode == "kernel"
            self.device = model.backend.device
        else:
            assert not self._sharded, \
                "sharded pools serve through PagedLM + ShardedPagedBackend"
            self.model = model or ToyModel(n_kv_heads=pool.cfg.n_kv_heads,
                                           head_dim=pool.cfg.head_dim)
            self.cache = PrefixCache(pool.cfg.block_size)
            self.cache.attach(pool)
            self.use_kernel = bool(use_kernel)
            self.device = resolve_device("cuda" if device is None else device)
        self.pipeline = pipeline
        self.max_lanes = max_lanes
        self.running: list[SeqState] = []
        # preempted decodes: (SeqState, pause record) pairs, oldest first
        self.paused: list = []
        self.finished: dict[int, list] = {}
        self.stats = EngineStats()
        self.obs = None          # telemetry hook (obs.Observer.attach)
        # admission-reservation bookkeeping per request: every actual block
        # allocation converts one reserved block into a live one; leftovers
        # release when the request's last lane finishes
        self._claims: dict[int, int] = {}
        self._live_seqs: dict[int, int] = {}
        self._sid_rid: dict[int, int] = {}

    @property
    def _lm(self) -> Optional[PagedLM]:
        return self.model if isinstance(self.model, PagedLM) else None

    def _unreserve(self, rid: int, n: int) -> None:
        """Release ``n`` of a request's admission reservation — on its
        routed shard for a sharded pool, aggregate otherwise."""
        if n == 0:
            return
        if self._sharded:
            self.pool.unreserve(n, rid=rid)
        else:
            self.pool.unreserve(n)

    def _claim(self, rid: int, n_allocs: int) -> None:
        take = min(self._claims.get(rid, 0), n_allocs)
        if take:
            self._unreserve(rid, take)
            self._claims[rid] -= take

    def _on_alloc(self, sid: int, n_allocs: int) -> None:
        self._claim(self._sid_rid[sid], n_allocs)

    def _finish_seq(self, seq: SeqState) -> None:
        if self.obs is not None:
            self.obs.trace.event("engine.free", rid=seq.rid, sid=seq.sid,
                                 tokens=seq.n_generated)
        self.finished.setdefault(seq.rid, []).append(seq.out_tokens)
        if self._lm is not None:
            self._lm.backend.free_seq(seq.sid)
            del self._sid_rid[seq.sid]
        else:
            self.cache.release(seq.table, self.pool)
        self._live_seqs[seq.rid] -= 1
        if self._live_seqs[seq.rid] == 0:
            del self._live_seqs[seq.rid]
            self._unreserve(seq.rid, self._claims.pop(seq.rid, 0))

    # -- admission / prefill -------------------------------------------------

    def submit(self, req: Request) -> bool:
        return self.scheduler.offer(req)

    def _prefill(self, req: Request) -> list[SeqState]:
        prompt = list(req.prompt)
        if self.obs is not None:
            shared0 = self.stats.shared_prompt_tokens
            with self.obs.trace.span("engine.prefill", rid=req.rid,
                                     tokens=len(prompt)) as sp:
                seqs = self._prefill_impl(req, prompt)
                sp["lanes"] = len(seqs)
                sp["shared"] = self.stats.shared_prompt_tokens - shared0
                return seqs
        return self._prefill_impl(req, prompt)

    def _prefill_impl(self, req: Request, prompt: list) -> list[SeqState]:
        self._claims[req.rid] = self._claims.get(req.rid, 0) \
            + req.blocks_needed(self.pool.cfg.block_size)
        self._live_seqs[req.rid] = self._live_seqs.get(req.rid, 0) \
            + req.n_samples
        if self._lm is not None:
            seqs = self._prefill_lm(req, prompt)
        else:
            seqs = self._prefill_toy(req, prompt)
        cname = getattr(req, "_cls", getattr(req, "traffic_class", "default"))
        for s in seqs:
            s.traffic_class = cname
            s.page = req.page
        self.stats.prefills += 1
        self.stats.prefill_tokens += len(prompt)
        return seqs

    def _prefill_toy(self, req: Request, prompt: list) -> list[SeqState]:
        bids, n = self.cache.match(prompt, self.pool)
        table = BlockTable(bids, n)
        rest = prompt[n:]
        allocs0 = self.pool.stats.allocs
        table.extend(self.pool, rest, seq_tokens=prompt, cache=self.cache,
                     kv=self.model.kv_for(rest))
        self._claim(req.rid, self.pool.stats.allocs - allocs0)
        self.stats.shared_prompt_tokens += n
        seqs = [SeqState(req.rid, prompt, table, req.max_new)]
        for i in range(1, req.n_samples):  # forks share all blocks (CoW later)
            seqs.append(SeqState(req.rid, list(prompt), table.fork(self.pool),
                                 req.max_new, salt=i))
        return seqs

    def _prefill_lm(self, req: Request, prompt: list) -> list[SeqState]:
        lm = self._lm
        allocs0 = self.pool.stats.allocs
        kw = {}
        if self._sharded:
            # the scheduler's routing decision (prefix-page affinity, then
            # shard load); None lets the backend pick
            kw["shard"] = getattr(req, "_shard", None)
        sid, logits, shared = lm.backend.new_seq(lm.params, prompt, **kw)
        self._sid_rid[sid] = req.rid
        self._claim(req.rid, self.pool.stats.allocs - allocs0)
        self.stats.shared_prompt_tokens += shared
        seqs = []
        for i in range(req.n_samples):
            s = sid if i == 0 else lm.backend.fork_seq(sid)
            self._sid_rid[s] = req.rid
            seqs.append(SeqState(req.rid, list(prompt), lm.backend.table(s),
                                 req.max_new, salt=i, sid=s,
                                 pending=lm.next_token(logits, i)))
        return seqs

    # -- one engine step ------------------------------------------------------

    def step(self, now: float = 0.0) -> int:
        """Admit + prefill into free lanes, then decode one token on every
        running lane.  Returns number of tokens generated this step.
        A no-op (returns 0 untouched) when nothing runs and nothing is
        queued."""
        if not self.running and not self.paused \
                and not len(self.scheduler):
            return 0
        obs = self.obs
        t0 = time.perf_counter() if obs is not None else 0.0
        # overload first: a latency-class arrival bounced since the last
        # step -> pause a throughput decode so this round's admission
        # sees the freed headroom
        preempted = self._maybe_preempt()
        free = self.max_lanes - len(self.running)
        if free > 0:
            # a request occupies one decode lane per forked sample
            for req in self.scheduler.schedule_batch(
                    free, now=now, cost_fn=lambda r: r.n_samples):
                if obs is not None:
                    obs.trace.event("engine.admit", rid=req.rid,
                                    n_samples=req.n_samples)
                self.running.extend(self._prefill(req))
        if not preempted:
            self._try_resume()
        if not self.running:
            return 0
        # page-coherent lane order: tail blocks grouped by row neighborhood
        # (the shard first when the pool is sharded: block ids are
        # shard-local, so equal ids on two shards are not neighbours)
        shard_ids = None
        if self._sharded and self._lm is not None:
            shard_ids = [self._lm.backend.shard_of(s.sid)
                         for s in self.running]
        order = ops.batch_lane_order([s.table for s in self.running],
                                     self.pool.cfg.blocks_per_group,
                                     shard_ids=shard_ids)
        self.running = [self.running[i] for i in order]

        nxt = self._decode_lm() if self._lm is not None \
            else self._decode_toy()

        still: list[SeqState] = []
        for seq, tok in zip(self.running, nxt):
            tok = self._commit_token(seq, int(tok))
            if seq.done:
                self._finish_seq(seq)
            else:
                if self._lm is None:
                    # append the token's KV for the next step (copy-on-write
                    # if the tail block is shared with a fork); the LM driver
                    # writes KV inside the backend instead
                    allocs0 = self.pool.stats.allocs
                    seq.table.extend(self.pool, [tok], seq_tokens=seq.tokens,
                                     cache=self.cache,
                                     kv=self.model.kv_for([tok]))
                    self._claim(seq.rid, self.pool.stats.allocs - allocs0)
                still.append(seq)
        self.running = still
        self.stats.steps += 1
        if obs is not None:
            obs.step_done(self, (time.perf_counter() - t0) * 1e3,
                          lanes=len(nxt), tokens=len(nxt))
        return len(nxt)

    # -- decode preemption (overload) ----------------------------------------

    def _maybe_preempt(self) -> bool:
        """Consume the scheduler's overload hint by pausing the running
        throughput-class decode with the most work left (LM driver,
        single-lane requests only)."""
        lm = self._lm
        if lm is None or not self.scheduler.take_preempt_hint():
            return False
        classes = getattr(self.scheduler, "classes", {})

        def latency(name: str) -> bool:
            c = classes.get(name)
            return c is not None and c.latency

        cand = [s for s in self.running
                if s.sid >= 0 and not latency(s.traffic_class)
                and self._live_seqs.get(s.rid, 0) == 1]
        if not cand:
            return False
        victim = max(cand, key=lambda s: s.max_new - s.n_generated)
        rec = lm.backend.pause_seq(victim.sid)
        if self.obs is not None:
            self.obs.trace.event("engine.pause", rid=victim.rid,
                                 sid=victim.sid,
                                 traffic_class=victim.traffic_class,
                                 tokens=victim.n_generated)
        self.running.remove(victim)
        del self._sid_rid[victim.sid]
        victim.sid = -1
        del self._live_seqs[victim.rid]
        self._unreserve(victim.rid, self._claims.pop(victim.rid, 0))
        self.paused.append((victim, rec))
        self.scheduler.note_preempt(victim.traffic_class)
        return True

    def _try_resume(self) -> None:
        """Opportunistic un-pause, oldest first, when a decode lane and
        pool headroom are both available again (re-routed through the
        sharded pool's page affinity, the pause shard as its tier hint,
        when the pool is sharded)."""
        lm = self._lm
        while self.paused and len(self.running) < self.max_lanes:
            seq, rec = self.paused[0]
            bs = self.pool.cfg.block_size
            need = -(-(len(seq.tokens) + seq.max_new - seq.n_generated)
                     // bs)
            if not self.pool.can_reserve(need):
                return
            self.pool.reserve(need)
            kw = {}
            if self._sharded:
                shard = self.pool.route(seq.rid, seq.page, need,
                                        tier_hint=rec.get("shard"))
                if shard is None:
                    self.pool.cancel_pending(need)
                    return
                kw["shard"] = shard
            self.paused.pop(0)
            self._claims[seq.rid] = self._claims.get(seq.rid, 0) + need
            self._live_seqs[seq.rid] = self._live_seqs.get(seq.rid, 0) + 1
            allocs0 = self.pool.stats.allocs
            sid = lm.backend.resume_seq(rec, **kw)
            self._sid_rid[sid] = seq.rid
            self._claim(seq.rid, self.pool.stats.allocs - allocs0)
            seq.sid = sid
            seq.table = lm.backend.table(sid)
            if self.obs is not None:
                self.obs.trace.event("engine.resume", rid=seq.rid, sid=sid,
                                     traffic_class=seq.traffic_class,
                                     tokens=seq.n_generated)
            self.running.append(seq)

    def _commit_token(self, seq: SeqState, tok: int) -> int:
        """The single decode-token commit path: one decode token per
        sequence stepped, forked lanes included."""
        seq.tokens.append(tok)
        seq.out_tokens.append(tok)
        seq.n_generated += 1
        self.stats.decode_tokens += 1
        if self.obs is not None:
            self.obs.trace.event("engine.token", rid=seq.rid, sid=seq.sid,
                                 n=seq.n_generated)
        return tok

    def _decode_toy(self) -> list:
        if self.obs is not None:
            # modelled row locality: the reference kernel's page walk for
            # this step (the LM driver feeds the same walk inside
            # backend.dispatch_decode)
            self.obs.observe_kv_walk(0, ops.kv_read_trace_kernel(
                [s.table for s in self.running],
                block_size=self.pool.cfg.block_size))
        pt, lengths = ops.pool_page_tables([s.table for s in self.running])
        dev = self.device
        q = torch.from_numpy(
            self.model.q_for([s.tokens[-1] for s in self.running])).to(dev)
        # stage the host-mutated pool buffers to the device once per step
        # (layer plane 0 — the toy model is single-layer)
        kp = self.pool.k_pages[0].to(dev)
        vp = self.pool.v_pages[0].to(dev)
        pt_d = torch.from_numpy(pt).to(dev)
        len_d = torch.from_numpy(lengths).to(dev)
        if self.use_kernel:
            from repro_torch.kernels.paged_attention.paged_attention import \
                paged_attention
            o = paged_attention(q, kp, vp, pt_d, len_d)
        else:
            o = paged_attention_ref(q, kp, vp, pt_d, len_d)
        return list(self.model.readout(o.cpu().numpy(),
                                       [s.salt for s in self.running]))

    def _decode_lm(self) -> list:
        """One ragged decode round: lanes holding a prefill-produced first
        token emit it; the rest advance through the backend together."""
        lm = self._lm
        nxt: dict[int, int] = {}
        live = [s for s in self.running if s.pending is None]
        for s in self.running:
            if s.pending is not None:
                nxt[id(s)] = s.pending
                s.pending = None
        if live:
            sids = [s.sid for s in live]
            toks = [s.tokens[-1] for s in live]
            if self.pipeline:
                logits = self._decode_lm_pipelined(sids, toks)
            else:
                logits = lm.backend.decode(lm.params, sids, toks,
                                           on_alloc=self._on_alloc)
            for s, lg in zip(live, logits):
                nxt[id(s)] = lm.next_token(lg, s.salt)
        return [nxt[id(s)] for s in self.running]

    def _decode_lm_pipelined(self, sids: list, toks: list):
        """Split-phase decode round: ``flush`` commits the PREVIOUS step's
        deferred KV write-back, ``dispatch_decode`` launches this step on
        every shard without blocking, ``sync`` blocks on the logits only.
        With an observer, the host-clock splits feed the
        ``engine.{commit,dispatch,sync}_ms`` histograms."""
        lm, obs = self._lm, self.obs
        backend = lm.backend
        t0 = time.perf_counter()
        backend.flush()
        t1 = time.perf_counter()
        step = backend.dispatch_decode(lm.params, toks, sids=sids,
                                       on_alloc=self._on_alloc)
        t2 = time.perf_counter()
        logits = backend.sync(step)
        t3 = time.perf_counter()
        if obs is not None:
            obs.registry.observe("engine.commit_ms", (t1 - t0) * 1e3)
            obs.registry.observe("engine.dispatch_ms", (t2 - t1) * 1e3)
            obs.registry.observe("engine.sync_ms", (t3 - t2) * 1e3)
        return logits

    def run(self, requests, *, max_steps: int = 10_000) -> dict[int, list]:
        """Drive submit/step to completion (the offline serving loop)."""
        pending = list(requests)
        for step_i in range(max_steps):
            while pending and self.submit(pending[0]):
                pending.pop(0)
            made = self.step(now=float(step_i))
            if not pending and not self.running and not self.paused \
                    and not len(self.scheduler):
                break
            if self.paused:
                continue   # a paused decode resumes once headroom returns
            if made == 0 and not self.running:
                if len(self.scheduler):
                    raise RuntimeError(
                        f"queued request needs more than max_lanes="
                        f"{self.max_lanes} decode lanes for its n_samples")
                if pending:
                    req = pending[0]
                    raise RuntimeError(
                        f"request {req.rid} needs "
                        f"{req.blocks_needed(self.pool.cfg.block_size)} "
                        f"blocks but the pool only ever frees "
                        f"{self.pool.num_free + self.pool.num_cached}")
        else:
            raise RuntimeError("engine did not drain within max_steps")
        return self.finished
