"""Serving entry points (port of ``repro/launch/serve.py``).

``python -m repro_torch.launch.serve --paged --config qwen1_5_0_5b``
``python -m repro_torch.launch.serve --paged --config hymba_1_5b``
``python -m repro_torch.launch.serve --paged --config arctic_480b --layers 2``
``python -m repro_torch.launch.serve --paged --config deepseek_coder_33b``
``python -m repro_torch.launch.serve --paged --tiered-kv --pool-blocks 24``
``python -m repro_torch.launch.serve --paged --shards 4 [--tiered-kv]``
``python -m repro_torch.launch.serve --config whisper_base``
``python -m repro_torch.launch.serve --config paligemma_3b``

Every config of the registry serves: the dense GQA models (qwen1.5-0.5b,
starcoder2-7b, phi3-medium-14b, deepseek-coder-33b), hymba-1.5b and the
MoE models through ``--paged`` or the dense backend; mamba2-370m,
whisper-base and paligemma-3b through the dense backend only, as in the
reference.

Full-LM paged serving: requests (some sharing prompt prefixes = "pages")
flow through the MARS scheduler into the continuous-batching engine,
which decodes every layer through ``PagedBackend`` — on a CUDA device the
attention of each layer and step runs the hand-written Hopper
``paged_attention`` kernel, every embedding lookup of a large table the
``mars_gather`` row-gather kernel, every unwindowed prefill the
``flash_attention`` kernel in each layer, a hybrid model's prefill the
``ssd_scan`` kernel in each layer (its decode carries the SSM state per
sequence beside the block tables), and an MoE model's three expert
products in each MoE layer the ``moe_dispatch`` grouped-GEMM kernel over
the MARS-sorted assignments.  ``--layers N`` cuts the model to its
first N layers at published width: one card holds 2 of arctic-480b's
35 layers, and 2 of kimi-k2's 61.  ``--tiered-kv`` puts host and mock
remote spill tiers behind the block pool (``kvcache.tiers``): eviction
demotes registered prefix blocks, prefix misses promote them back.
``--shards N`` partitions the pool into N shard pools, each with its own
backend, prefix cache, tiers and device mirror pair, the scheduler
routing admissions by prefix page, tier hint and shard load; the shards
map round robin onto the CUDA devices there are (one H100: all N on
it).  A teacher-forced check re-runs a sample of served sequences
through the port's own ``DenseBackend``.  ``--toy`` serves the
single-layer ToyModel instead.

Without ``--paged`` (``main_dense``) the requests flow through the MARS
scheduler into batches, each prefilled and greedily decoded through the
``DenseBackend`` (``serve.step.greedy_generate``), once with
``mars=False`` and once with ``mars=True``; this is how the pure-SSM
(mamba2), encoder-decoder (whisper) and VLM (paligemma) families serve,
as in the reference.  On a CUDA device every attention over the whole
prompt, the encoder's and the cross-attention run the
``flash_attention`` kernel, every embedding lookup of a large table
``mars_gather`` and every SSM prefill ``ssd_scan``.  An encoder-decoder
model's frame embeddings are the reference tests' stub, ``normal *
0.02`` of shape (batch, frontend_seq, d_model), drawn from the
``--seed`` generator.  A VLM serves its text-only decoder: the
reference's ``main`` passes no image prefix, and its prefill would not
read one (ROADMAP.md §3).

``--metrics`` (with ``--paged``) serves instrumented: an
``obs.Observer`` wired through the engine, scheduler, pool(s),
backend(s) and tiers; right after the engine's run (before the
teacher-forced check, whose prefills stay out of it) it writes
``<--metrics-path>/metrics.json`` (the registry snapshot) and
``trace.jsonl`` (the span/event log) and prints a summary.  Spans and
the ``engine.{step,commit,dispatch,sync}_ms`` histograms are host time;
``dram.row_hit_pct`` is the reference's order model on the paper's DRAM
map, not a reading of the card.  ``--paranoid`` adds the pool's
incremental invariant sweep every few engine steps.

Runs on ``--device cuda`` (the default; raises when CUDA is absent) or
``--device cpu``.  Weights are random, from ``lm.init`` seeded by
``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.step import greedy_generate
from repro_torch.serving.scheduler import MarsScheduler, Request, \
    default_classes, unique_prefix_blocks

# Near-tie margin of the teacher-forced check, in spacings of the compute
# dtype at a position's largest logit.  In bfloat16 the paged paths and
# the dense path round differently (the kernel accumulates attention in
# f32 where the dense path rounds scores and weights to bf16; GEMMs run
# at other batch shapes).  At hymba-1.5b's full width (32 layers,
# |logit| about 4.7) that moves a served token's dense logit by several
# bf16 spacings on an H100 — the gather path, which runs the dense math
# itself at other batch shapes, as far as the kernel path — so the
# margin is 16 spacings.  chip_smoke.py prints the largest
# deficit of each run (``parity_max_deficit``).  In float32 both paths
# agree on the argmax and the check is exact.
NEAR_TIE_SPACINGS = 16
MIN_NEAR_TIE_MARGIN = 5e-2
# Measured noise term of the bf16 margin.  The check also teacher-forces
# the checked sequences through the dense backend all in one batch; that
# pass runs the same math at other GEMM shapes, so at each position the
# largest |logit| difference between it and the batch-of-one pass
# measures the dense path's own rounding noise on that model and card.
# Its median over the checked positions, delta, is the run's noise scale
# (the median, because an MoE router that picks another expert at one
# position moves that position's logits by far more than rounding).  If
# the served path and the dense path each stay within delta of the exact
# logits, a served token's dense deficit is at most 4 delta: it beat the
# dense argmax on the served path, and each of the two logits moved at
# most 2 delta between the paths.  At hymba-1.5b's full width the dense
# math alone moves logits near 4 by about 0.3 between batch shapes, more
# than 16 spacings (PERF.md §6); the margin is the larger of the two.
# Never in float32.
NOISE_FACTOR = 4


def near_tie_margin(logits: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Per-position margin (n,) for dense logits (n, V) computed in
    ``dtype``: 0 in float32 (served tokens must be the dense argmax),
    else ``NEAR_TIE_SPACINGS`` spacings of ``dtype`` at the position's
    largest |logit|, at least ``MIN_NEAR_TIE_MARGIN``."""
    if dtype == torch.float32:
        return np.zeros(logits.shape[0])
    top = np.maximum(np.abs(logits).max(-1), np.finfo(np.float32).tiny)
    spacing = torch.finfo(dtype).eps * np.exp2(np.floor(np.log2(top)))
    return np.maximum(MIN_NEAR_TIE_MARGIN, NEAR_TIE_SPACINGS * spacing)


def _dense_noise(params, cfg, reqs, served, singles, device):
    """Per-position dense rounding noise of the checked sequences (list of
    (n,) arrays): the largest |logit| difference between teacher-forcing
    each sequence alone (``singles``, its (n, V) dense logits) and all of
    them in one batch (grouped by prompt and served length).  None in
    float32, where the check is exact.  Returns (noise, batched prefills,
    batched decode steps)."""
    if cfg.cdtype == torch.float32 or not reqs:
        return None, 0, 0
    groups: dict = {}
    for j, (r, got) in enumerate(zip(reqs, served)):
        groups.setdefault((len(r.prompt), len(got)), []).append(j)
    noise = [None] * len(reqs)
    steps = 0
    for idx in groups.values():
        batch, _ = _dense_forced_logits(
            params, cfg, [list(reqs[j].prompt) for j in idx],
            [served[j] for j in idx], device)
        steps += len(served[idx[0]]) - 1
        for a, j in enumerate(idx):
            noise[j] = np.abs(batch[a] - singles[j]).max(-1)
    return noise, len(groups), steps


# --classes N: per-class decode-length profile for the synthetic stream —
# interactive stays short, batch decodes long, stream sits between; the
# multipliers scale --new-tokens
_CLASS_NEW_TOKENS = {"interactive": 1, "batch": 4, "stream": 2}


def synth_requests(n: int, vocab: int, n_prefixes: int = 8,
                   prefix_len: int = 16, seed: int = 0):
    """Interleaved request streams: n_prefixes hot prompt prefixes."""
    rng = np.random.default_rng(seed)
    prefixes = [tuple(rng.integers(1, vocab, prefix_len).tolist())
                for _ in range(n_prefixes)]
    out = []
    for i in range(n):
        p = prefixes[i % n_prefixes]       # round-robin = interleaved
        tail = tuple(rng.integers(1, vocab, 8).tolist())
        out.append(Request(rid=i, prompt=p + tail, arrival=i * 1e-3,
                           prefix_len=prefix_len))
    return out


def _attach_metrics(args, eng):
    """--metrics: wire an ``obs.Observer`` through the engine (spans,
    counters, the modelled row-hit gauge; ``--paranoid`` adds the
    periodic incremental invariant sweep).  None when telemetry is
    off."""
    if not args.metrics:
        return None
    from repro_torch.obs import Observer
    return Observer(paranoid=args.paranoid).attach(eng)


def _dump_metrics(obs, args):
    """Write ``<metrics-path>/metrics.json`` (registry snapshot) and
    ``<metrics-path>/trace.jsonl`` (span/event log), then print the
    one-screen summary table."""
    if obs is None:
        return
    import json
    import os
    os.makedirs(args.metrics_path, exist_ok=True)
    snap_path = os.path.join(args.metrics_path, "metrics.json")
    trace_path = os.path.join(args.metrics_path, "trace.jsonl")
    with open(snap_path, "w", encoding="utf-8") as fh:
        json.dump(obs.snapshot(), fh, indent=1, sort_keys=True)
        fh.write("\n")
    open(trace_path, "w").close()       # fresh file; flush() appends
    n = obs.trace.flush(trace_path)
    print("[metrics] " + "-" * 50)
    for line in obs.summary_lines():
        print(f"[metrics]   {line}")
    print("[metrics] " + "-" * 50)
    print(f"[metrics] snapshot -> {snap_path}")
    print(f"[metrics] trace    -> {trace_path} ({n} events)")


def main_paged_toy(args):
    """Continuous batching over the paged KV pool with the deterministic
    single-layer ToyModel: admission bounded by pool capacity,
    prefix-shared blocks, MARS-aware placement, CoW forks."""
    from repro_torch.kvcache import BlockPool, PoolConfig
    from repro_torch.serve.engine import ServeEngine

    pool = BlockPool(PoolConfig(num_blocks=args.pool_blocks, block_size=16,
                                n_kv_heads=2, head_dim=64))
    sched = MarsScheduler(pool=pool)
    eng = ServeEngine(pool, sched, max_lanes=args.batch,
                      use_kernel=args.kernel_decode, device=args.device)
    obs = _attach_metrics(args, eng)
    reqs = [Request(rid=r.rid, prompt=r.prompt, arrival=r.arrival,
                    prefix_len=r.prefix_len, max_new=args.new_tokens)
            for r in synth_requests(args.requests, vocab=128,
                                    seed=args.seed)]
    t0 = time.time()
    finished = eng.run(reqs)
    dt = time.time() - t0
    _dump_metrics(obs, args)
    print(f"[serve --paged --toy] served={len(finished)} "
          f"steps={eng.stats.steps} "
          f"prefill_tokens={eng.stats.prefill_tokens} "
          f"decode_tokens={eng.stats.decode_tokens} "
          f"prefix_hits={pool.stats.prefix_hits} "
          f"shared_prompt_tokens={eng.stats.shared_prompt_tokens} "
          f"evictions={pool.stats.evictions} "
          f"pool_rejects={sched.stats.pool_rejects} wall={dt:.1f}s")
    pool.check_invariants()
    return dict(served=len(finished), steps=eng.stats.steps,
                prefix_hits=pool.stats.prefix_hits,
                pool_rejects=sched.stats.pool_rejects,
                finished=finished, obs=obs)


def cut_depth(cfg, n_layers: int):
    """``cfg`` cut to its first ``n_layers`` layers, widths unchanged.
    Raises above the config's depth, and at or below an MoE config's
    ``n_dense_layers`` (the cut must keep a routed layer)."""
    if n_layers > cfg.n_layers:
        raise ValueError(f"--layers {n_layers} exceeds {cfg.name}'s "
                         f"{cfg.n_layers} layers")
    floor = cfg.n_dense_layers if cfg.is_moe else 0
    if n_layers <= floor:
        raise ValueError(f"--layers {n_layers} keeps no layer past "
                         f"{cfg.name}'s {floor} leading dense layer(s)")
    return dataclasses.replace(cfg, n_layers=n_layers)


def _dense_forced_logits(params, cfg, prompts, forced, device):
    """Teacher-force the port's dense backend along the ``forced`` token
    lists, one per prompt, in one batch (every prompt of one length, every
    forced list of one length): one prefill, ``n - 1`` decode steps.
    Returns the dense logits (B, n, V) seen before each forced token and,
    for an MoE model, the smallest router gap (k-th minus (k+1)-th
    probability, over its MoE layers) of the token each position was
    computed from, (B, n); else None."""
    from repro_torch.models import moe
    B, S = len(prompts), len(prompts[0])
    gaps = []

    def step(fn, rows):
        moe.ROUTER_GAPS = [] if cfg.is_moe else None
        try:
            logits = fn()
            if cfg.is_moe:
                gaps.append(torch.stack([g.view(B, -1)[:, -1]
                                         for g in moe.ROUTER_GAPS])
                            .min(0).values.cpu().numpy())
        finally:
            moe.ROUTER_GAPS = None
        return logits[:, -1].float().cpu().numpy()
    backend = lm.init_cache(cfg, B, S + len(forced[0]) + 1, device=device)
    out = [step(lambda: backend.prefill(params, torch.tensor(
        prompts, dtype=torch.int32, device=device)), S)]
    for i in range(len(forced[0]) - 1):
        toks = [[f[i]] for f in forced]
        out.append(step(lambda: backend.decode_step(params, toks), 1))
    return (np.stack(out, 1),
            np.stack(gaps, 1) if cfg.is_moe else None)


def main_paged(args):
    """Full-LM paged serving: a real ``ModelConfig`` model decoded through
    ``PagedBackend`` by the continuous-batching engine — every layer's KV
    in the layered block pool, ragged lanes, prefix sharing, CoW forks.
    Decode runs ``paged_attention`` per layer (``--kernel-decode``,
    default) or the gathered dense view (``--no-kernel-decode``).
    ``--tiered-kv`` adds spill tiers behind the pool(s); ``--shards N``
    serves through ``ShardedPagedBackend`` over a serving mesh.
    Cross-checks a sample of served sequences against the dense backend
    for end-to-end token parity.  Returns the run's stats with
    ``finished`` (request id -> served token lists), ``cfg``, ``params``,
    ``prompts`` (request id -> prompt), ``max_new`` (request id -> its
    decode length), ``backend`` (unreleased, for the caller's own checks)
    and ``obs`` (the ``--metrics`` observer, or None).  ``decode_steps``
    counts the model's decode steps: one per shard a round."""
    if args.toy:
        return main_paged_toy(args)
    from repro_torch.kvcache.backend import make_backend
    from repro_torch.serve.engine import PagedLM, ServeEngine

    device = resolve_device(args.device)
    cfg = _config(args)
    depth = cfg.n_layers
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    assert cfg.n_layers > 1, "full-LM paged serving needs a multi-layer cfg"
    params = lm.init(cfg, torch.Generator(device).manual_seed(args.seed))
    decode_mode = "kernel" if args.kernel_decode else "gather"
    if args.shards > 1:
        # one block pool + paged backend per shard of the serving mesh's
        # model axis, each shard's mirrors on its device (round robin
        # when there are fewer devices than shards)
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.sharding import context as shctx
        mesh = mesh_mod.make_serve_mesh(args.shards, device)
        devices = [mesh.devices[s % len(mesh.devices)]
                   for s in range(args.shards)]
        with shctx.use_mesh(mesh):
            pool_blocks = -(-args.pool_blocks // args.shards) * args.shards
            backend = make_backend(
                cfg, "paged", shards=args.shards, devices=devices,
                num_blocks=pool_blocks, block_size=16,
                decode_mode=decode_mode, tiered=args.tiered_kv)
        print(f"[serve --paged {cfg.name}] shards={args.shards} "
              f"mesh_devices={len(mesh.devices)} "
              f"blocks/shard={backend.pool.shard_blocks}")
        inner = backend.backends
    else:
        backend = make_backend(
            cfg, "paged", num_blocks=args.pool_blocks, block_size=16,
            decode_mode=decode_mode, device=device, tiered=args.tiered_kv)
        inner = [backend]
    pool = backend.pool
    classes = default_classes(args.classes) if args.classes > 1 else None
    sched = MarsScheduler(pool=pool, classes=classes)
    if args.tiered_kv and args.shards > 1:
        # admission counts a promotable lower-tier prefix hit toward
        # shard routing: land the request where its demoted blocks are
        sched.tier_probe = backend.tier_shard_for
    eng = ServeEngine(pool, sched, PagedLM(params, cfg, backend),
                      max_lanes=args.batch, pipeline=args.pipeline)
    obs = _attach_metrics(args, eng)
    cnames = [c.name for c in classes] if classes else None
    reqs = []
    for r in synth_requests(args.requests, vocab=cfg.vocab,
                            n_prefixes=args.prefixes, seed=args.seed):
        cname = cnames[r.rid % len(cnames)] if cnames else "default"
        mult = _CLASS_NEW_TOKENS.get(cname, 1) if cnames else 1
        reqs.append(Request(rid=r.rid, prompt=r.prompt, arrival=r.arrival,
                            prefix_len=r.prefix_len,
                            max_new=args.new_tokens * mult,
                            traffic_class=cname))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    finished = eng.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    pool.check_invariants()
    _dump_metrics(obs, args)
    decode_steps = sum(b._steps for b in inner)
    cut = f" (cut from {depth})" if cfg.n_layers != depth else ""
    shard_note = "" if args.shards <= 1 else \
        f"shards={args.shards} shard_defers={sched.stats.shard_defers} "
    print(f"[serve --paged {cfg.name}] device={device} "
          f"layers={cfg.n_layers}{cut} "
          f"decode={backend.decode_mode} "
          f"pipeline={'on' if args.pipeline else 'off'} {shard_note}"
          f"served={len(finished)} steps={eng.stats.steps} "
          f"decode_steps={decode_steps} "
          f"prefill_tokens={eng.stats.prefill_tokens} "
          f"decode_tokens={eng.stats.decode_tokens} "
          f"prefix_hits={pool.stats.prefix_hits} "
          f"evictions={pool.stats.evictions} "
          f"pool_rejects={sched.stats.pool_rejects} wall={dt:.3f}s")
    if classes:
        for cname, cs in sched.class_stats.items():
            h = sched.wait_hist[cname]
            print(f"[serve --paged {cfg.name}] class {cname}: "
                  f"admit={cs.admit} reject={cs.reject} defer={cs.defer} "
                  f"preempt={cs.preempt} scheduled={cs.scheduled} "
                  f"wait p50={h.quantile(0.5):.1f}ms "
                  f"p99={h.quantile(0.99):.1f}ms")
    if args.shards > 1:
        from repro_torch.obs.observer import shard_load_snapshot
        for row, b in zip(shard_load_snapshot(pool), inner):
            mirror = sum(m.numel() * m.element_size()
                         for slot in b._mirrors if slot is not None
                         for m in slot)
            print(f"[serve --paged {cfg.name}] shard {row['shard']}: "
                  f"decode_steps={b._steps} live={row['live']} "
                  f"cached={row['cached']} free={row['free']} "
                  f"load={row['load']} occupancy={row['occupancy']:.3f} "
                  f"prefix_hits={b.pool.stats.prefix_hits} "
                  f"evictions={b.pool.stats.evictions} "
                  f"mirror_bytes={mirror}")
    tiers = [b.tiers for b in inner if b.tiers is not None]
    tier_stats = {f: sum(getattr(t.stats, f) for t in tiers)
                  for f in tiers[0].stats.fields()} if tiers else {}
    if tiers:
        held = sum(t_.nbytes for t in tiers for t_ in t.tiers)
        print(f"[serve --paged {cfg.name}] tiers: "
              + " ".join(f"{k}={v}" for k, v in tier_stats.items()
                         if k != "stall_us")
              + f" stall_us={tier_stats['stall_us']:.1f} (modelled) "
              f"held_bytes={held}")
        for t in tiers:
            t.check()

    # dense-vs-paged parity on a sample of served requests (salt-0 lane of
    # each request is plain greedy): the check teacher-forces the dense
    # backend along the *served* tokens and requires every served token's
    # dense logit to be within a near-tie margin of the dense argmax —
    # exact in float32, a few compute-dtype spacings otherwise
    # (``near_tie_margin``).
    n_check = min(args.parity_checks, len(reqs))
    checked = reqs[:n_check]
    served = [finished[r.rid][0] for r in checked]
    singles = [_dense_forced_logits(params, cfg, [list(r.prompt)], [got],
                                    device) for r, got in zip(checked, served)]
    noise, batch_prefills, batch_steps = _dense_noise(
        params, cfg, checked, served, [d[0][0] for d in singles], device)
    noise_scale = None if noise is None else \
        float(np.median(np.concatenate(noise)))
    mismatches = exact = parity_decode_steps = 0
    max_margin = max_deficit = 0.0
    for j, req in enumerate(checked):
        got = served[j]
        parity_decode_steps += len(got) - 1
        dense, gaps = singles[j]
        dense = dense[0]
        gaps = None if gaps is None else gaps[0]
        margin = near_tie_margin(dense, cfg.cdtype)
        if noise is not None:
            margin = np.maximum(margin, NOISE_FACTOR * noise_scale)
        max_margin = max(max_margin, float(margin.max()))
        max_deficit = max(max_deficit, max(
            float(dense[i].max() - dense[i, t]) for i, t in enumerate(got)))
        if list(dense.argmax(-1)) == got:
            exact += 1
        elif any(dense[i, t] < dense[i].max() - margin[i]
                 for i, t in enumerate(got)):
            mismatches += 1
        for i, t in enumerate(got):
            if dense[i, t] < dense[i].max():
                top2 = np.sort(dense[i])[-2:]
                print(f"[serve --paged {cfg.name}] check: request "
                      f"{req.rid} position {i}: served {t} (dense logit "
                      f"{dense[i, t]:.4g}), dense argmax "
                      f"{int(dense[i].argmax())} ({top2[1]:.4g}), deficit "
                      f"{top2[1] - dense[i, t]:.4g}, margin {margin[i]:.4g}"
                      + ("" if noise is None else
                         f" (dense noise {noise[j][i]:.4g})") + ", "
                      f"dense top-2 gap {top2[1] - top2[0]:.4g}"
                      + ("" if gaps is None else
                         f", smallest router top-k gap {gaps[i]:.3g}"))
    print(f"[serve --paged {cfg.name}] dense-vs-{backend.decode_mode} "
          f"parity: {n_check - mismatches}/{n_check} sequences match "
          f"({exact} argmax-exact, largest deficit {max_deficit:.4g}, "
          f"margin<={max_margin:.4g}"
          + ("" if noise is None else
             f", dense noise median {noise_scale:.4g} largest "
             f"{max(float(n.max()) for n in noise):.4g}")
          + ")")
    if mismatches:
        raise AssertionError(f"{backend.decode_mode} paged serving diverged "
                             f"from the dense backend on {mismatches} of "
                             f"{n_check} sequences")
    return dict(served=len(finished), steps=eng.stats.steps,
                cfg=cfg, prefills=eng.stats.prefills,
                decode_steps=decode_steps,
                shard_defers=sched.stats.shard_defers,
                tier_probe=sched.tier_probe is not None,
                evictions=pool.stats.evictions, tiers=tier_stats,
                decode_tokens=eng.stats.decode_tokens,
                prefix_hits=pool.stats.prefix_hits, wall_s=dt,
                parity_checked=n_check, parity_mismatches=mismatches,
                parity_decode_steps=parity_decode_steps,
                parity_noise=noise_scale,
                parity_batch_prefills=batch_prefills,
                parity_batch_decode_steps=batch_steps,
                parity_max_deficit=max_deficit,
                decode=backend.decode_mode, finished=finished,
                params=params, prompts={r.rid: r.prompt for r in reqs},
                max_new={r.rid: r.max_new for r in reqs},
                backend=backend, obs=obs)


def _config(args):
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    return cfg


def frontend_stub(cfg, batch: int, gen: torch.Generator):
    """An encoder-decoder model's stub frame embeddings, ``normal * 0.02``
    of shape (batch, frontend_seq, d_model) in the compute dtype, drawn
    from ``gen`` (the reference tests' frontend); None for other
    families, a VLM's included: its serving path is the text-only
    decoder, as the reference's ``main`` serves it."""
    if cfg.family != "encdec":
        return None
    x = torch.randn((batch, cfg.frontend_seq, cfg.d_model), generator=gen,
                    device=gen.device) * 0.02
    return x.to(cfg.cdtype)


def main_dense(args):
    """The dense-backend scheduler path: the synthetic requests through
    ``MarsScheduler(mars=False)``, then ``mars=True``, each batch served
    by ``greedy_generate`` over a ``DenseBackend`` (prefill + ``--new-
    tokens`` decode steps).  Returns ``{False: stats, True: stats, "cfg":
    cfg, "params": params}``; each stats dict holds the reference's
    ``served``, ``batches``, ``blocks_per_batch``, ``mean_wait`` and
    ``wall_s`` (ending in a device synchronize), plus ``outputs``: per
    batch its request ids, prompts (B, S), frame embeddings (or None)
    and generated tokens (B, new_tokens + 1), on the device."""
    device = resolve_device(args.device)
    cfg = _config(args)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = lm.init(cfg, gen)
    reqs = synth_requests(args.requests, cfg.vocab, seed=args.seed)
    results = {}
    for mars in (False, True):
        sched = MarsScheduler(mars=mars)
        pending = list(reqs)
        served = blocks = batches = 0
        outputs = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        while pending or len(sched):
            while pending and sched.offer(pending[0]):
                pending.pop(0)
            batch = sched.schedule_batch(args.batch)
            if not batch:
                break
            blocks += unique_prefix_blocks(batch)
            batches += 1
            # run the batch through the dense KV backend: prefill the
            # (page-shared) prompts + greedy decode
            prompts = torch.tensor([r.prompt for r in batch],
                                   dtype=torch.int32, device=device)
            frontend = frontend_stub(cfg, len(batch), gen)
            toks = greedy_generate(params, cfg, prompts, args.new_tokens + 1,
                                   max_seq=prompts.shape[1]
                                   + args.new_tokens + 1, frontend=frontend)
            outputs.append(dict(rids=[r.rid for r in batch], prompts=prompts,
                                frontend=frontend, tokens=toks))
            served += len(batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        results[mars] = dict(served=served, batches=batches,
                             blocks_per_batch=blocks / max(batches, 1),
                             mean_wait=sched.stats.mean_wait, wall_s=dt,
                             outputs=outputs)
        print(f"[serve] mars={mars} served={served} batches={batches} "
              f"unique-prefix-blocks/batch={blocks/max(batches,1):.2f} "
              f"wall={dt:.1f}s")
    base, mars_r = results[False], results[True]
    gain = base["blocks_per_batch"] / max(mars_r["blocks_per_batch"], 1e-9)
    print(f"[serve] MARS page-coherence gain: {gain:.2f}x fewer unique "
          f"prefix blocks per batch")
    results.update(cfg=cfg, params=params)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--config", dest="arch", default="qwen1_5_0_5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--prefixes", type=int, default=8,
                    help="distinct hot prompt prefixes in the synthetic "
                         "stream")
    ap.add_argument("--paged", action="store_true",
                    help="serve a real config through the paged KV backend "
                         "and the continuous-batching engine (default: "
                         "MARS-scheduled batches through the dense "
                         "backend)")
    ap.add_argument("--kernel-decode", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --paged: decode through paged_attention per "
                         "layer (default on); --no-kernel-decode uses the "
                         "gathered dense view")
    ap.add_argument("--toy", action="store_true",
                    help="with --paged: single-layer ToyModel engine demo")
    ap.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --paged: drive the split-phase decode "
                         "pipeline (default on); --no-pipeline serves "
                         "through the synchronous decode() wrapper")
    ap.add_argument("--shards", type=int, default=1,
                    help="with --paged: partition the KV pool across this "
                         "many shards (per-shard pools, prefix caches, "
                         "tiers and device mirrors, prefix-affinity "
                         "admission routing, per-shard kernel decode); "
                         "shards map round robin onto the devices there "
                         "are")
    ap.add_argument("--tiered-kv", action="store_true",
                    help="with --paged: spill tiers behind the block "
                         "pool(s) — eviction demotes registered prefix "
                         "blocks to host/remote tiers, prefix misses "
                         "promote them back (MARS-reordered batched "
                         "copy-in); size --pool-blocks small and "
                         "--prefixes large to force spill traffic")
    ap.add_argument("--pool-blocks", type=int, default=256)
    ap.add_argument("--classes", type=int, default=0,
                    help="with --paged (full-LM): install the first N "
                         "default_classes() traffic classes (0/1 = "
                         "class-blind)")
    ap.add_argument("--parity-checks", type=int, default=4,
                    help="with --paged: served sequences re-checked densely")
    ap.add_argument("--metrics", action="store_true",
                    help="with --paged: serve instrumented (obs.Observer) "
                         "and dump a JSON metrics snapshot + JSONL span "
                         "trace, plus a one-screen summary (host-clock "
                         "times; the row-hit gauge is a model)")
    ap.add_argument("--metrics-path", default="metrics_out",
                    help="directory for metrics.json / trace.jsonl")
    ap.add_argument("--paranoid", action="store_true",
                    help="with --metrics: run the pool's incremental "
                         "invariant sweep every few engine steps")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model and kernels run; cuda raises "
                         "when no GPU is available")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="parameter and compute dtype (default: the "
                         "config's); float32 makes the teacher-forced "
                         "check exact")
    ap.add_argument("--layers", type=int,
                    help="serve only the config's first N layers, at its "
                         "published widths: one card holds 2 of "
                         "arctic-480b's 35 layers, where the JAX package "
                         "would shard the model; must exceed an MoE "
                         "config's leading dense layers")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the request stream")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if not args.paged:
        return main_dense(args)
    return main_paged(args)


if __name__ == "__main__":
    main()
