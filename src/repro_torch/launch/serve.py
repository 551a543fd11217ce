"""Serving driver (port of ``repro/launch/serve.py``, paged path).

``python -m repro_torch.launch.serve --paged --config qwen1_5_0_5b``
``python -m repro_torch.launch.serve --paged --config hymba_1_5b``

Full-LM paged serving: requests (some sharing prompt prefixes = "pages")
flow through the MARS scheduler into the continuous-batching engine,
which decodes every layer through ``PagedBackend`` — on a CUDA device the
attention of each layer and step runs the hand-written Hopper
``paged_attention`` kernel, every embedding lookup of a large table the
``mars_gather`` row-gather kernel, and a hybrid model's prefill the
``ssd_scan`` kernel in each layer (its decode carries the SSM state per
sequence beside the block tables).  A teacher-forced check re-runs a sample of
served sequences through the port's own ``DenseBackend``.  ``--toy``
serves the single-layer ToyModel instead.

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
from repro_torch.serving.scheduler import MarsScheduler, Request, \
    default_classes

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
    reqs = [Request(rid=r.rid, prompt=r.prompt, arrival=r.arrival,
                    prefix_len=r.prefix_len, max_new=args.new_tokens)
            for r in synth_requests(args.requests, vocab=128,
                                    seed=args.seed)]
    t0 = time.time()
    finished = eng.run(reqs)
    dt = time.time() - t0
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
                finished=finished)


def _dense_forced_logits(params, cfg, prompt, forced, device):
    """Teacher-force the port's dense backend along ``forced`` tokens
    (one prefill, ``len(forced) - 1`` decode steps); returns the dense
    logits (n, V) seen before each forced token."""
    logits, backend = lm.prefill(
        params, cfg, torch.tensor([prompt], dtype=torch.int32, device=device),
        max_seq=len(prompt) + len(forced) + 1)
    out = [logits[0, -1].float().cpu().numpy()]
    for tok in forced[:-1]:
        logits = backend.decode_step(params, [[tok]])
        out.append(logits[0, -1].float().cpu().numpy())
    return np.stack(out)


def main_paged(args):
    """Full-LM paged serving: a real ``ModelConfig`` model decoded through
    ``PagedBackend`` by the continuous-batching engine — every layer's KV
    in the layered block pool, ragged lanes, prefix sharing, CoW forks.
    Decode runs ``paged_attention`` per layer (``--kernel-decode``,
    default) or the gathered dense view (``--no-kernel-decode``).
    Cross-checks a sample of served sequences against the dense backend
    for end-to-end token parity."""
    if args.toy:
        return main_paged_toy(args)
    from repro_torch.kvcache.backend import make_backend
    from repro_torch.serve.engine import PagedLM, ServeEngine

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.dtype,
                                  compute_dtype=args.dtype)
    assert cfg.n_layers > 1, "full-LM paged serving needs a multi-layer cfg"
    params = lm.init(cfg, torch.Generator(device).manual_seed(args.seed))
    backend = make_backend(
        cfg, "paged", num_blocks=args.pool_blocks, block_size=16,
        decode_mode="kernel" if args.kernel_decode else "gather",
        device=device)
    pool = backend.pool
    classes = default_classes(args.classes) if args.classes > 1 else None
    sched = MarsScheduler(pool=pool, classes=classes)
    eng = ServeEngine(pool, sched, PagedLM(params, cfg, backend),
                      max_lanes=args.batch, pipeline=args.pipeline)
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
    print(f"[serve --paged {cfg.name}] device={device} layers={cfg.n_layers} "
          f"decode={backend.decode_mode} "
          f"pipeline={'on' if args.pipeline else 'off'} "
          f"served={len(finished)} steps={eng.stats.steps} "
          f"decode_steps={backend._steps} "
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

    # dense-vs-paged parity on a sample of served requests (salt-0 lane of
    # each request is plain greedy): the check teacher-forces the dense
    # backend along the *served* tokens and requires every served token's
    # dense logit to be within a near-tie margin of the dense argmax —
    # exact in float32, a few compute-dtype spacings otherwise
    # (``near_tie_margin``).
    n_check = min(args.parity_checks, len(reqs))
    mismatches = exact = parity_decode_steps = 0
    max_margin = max_deficit = 0.0
    for req in reqs[:n_check]:
        got = finished[req.rid][0]
        parity_decode_steps += len(got) - 1
        dense = _dense_forced_logits(params, cfg, list(req.prompt), got,
                                     device)
        margin = near_tie_margin(dense, cfg.cdtype)
        max_margin = max(max_margin, float(margin.max()))
        max_deficit = max(max_deficit, max(
            float(dense[i].max() - dense[i, t]) for i, t in enumerate(got)))
        if list(dense.argmax(-1)) == got:
            exact += 1
        elif any(dense[i, t] < dense[i].max() - margin[i]
                 for i, t in enumerate(got)):
            mismatches += 1
    print(f"[serve --paged {cfg.name}] dense-vs-{backend.decode_mode} "
          f"parity: {n_check - mismatches}/{n_check} sequences match "
          f"({exact} argmax-exact, largest deficit {max_deficit:.4g}, "
          f"margin<={max_margin:.4g})")
    if mismatches:
        raise AssertionError(f"{backend.decode_mode} paged serving diverged "
                             f"from the dense backend on {mismatches} of "
                             f"{n_check} sequences")
    return dict(served=len(finished), steps=eng.stats.steps,
                prefills=eng.stats.prefills,
                decode_steps=backend._steps,
                decode_tokens=eng.stats.decode_tokens,
                prefix_hits=pool.stats.prefix_hits, wall_s=dt,
                parity_checked=n_check, parity_mismatches=mismatches,
                parity_decode_steps=parity_decode_steps,
                parity_max_deficit=max_deficit,
                decode=backend.decode_mode, finished=finished)


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
                         "(the only serving path ported so far)")
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
    ap.add_argument("--pool-blocks", type=int, default=256)
    ap.add_argument("--classes", type=int, default=0,
                    help="with --paged (full-LM): install the first N "
                         "default_classes() traffic classes (0/1 = "
                         "class-blind)")
    ap.add_argument("--parity-checks", type=int, default=4,
                    help="with --paged: served sequences re-checked densely")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model and kernels run; cuda raises "
                         "when no GPU is available")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="parameter and compute dtype (default: the "
                         "config's); float32 makes the teacher-forced "
                         "check exact")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the random weights and the request stream")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if not args.paged:
        ap.error("only --paged serving is ported to torch so far")
    return main_paged(args)


if __name__ == "__main__":
    main()
