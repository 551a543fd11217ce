#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root
    python3 chip_smoke.py --phases k5        # a subset; prints no result

Phases (any failure exits non-zero and prints no result):

  build   compile every CUDA kernel of the port from ``src/repro_torch/
          csrc`` (paged_attention, ssd_scan, mars_gather, moe_dispatch,
          flash_attention, mars_engine, dram_channel,
          flash_attention_bwd, embedding_grad_scatter) with nvcc for
          sm_90a (one nvcc per source, started together) into the
          git-ignored ``build/``.
  k1      K1, its split kernel and its merge kernel: paged_attention's
          state against the plain oracle, decode_attend against
          decode_attend_plain on the card and against the same call on
          host copies, the merge kernel alone against
          merge_partials_plain on the split kernel's partials (and, with
          a forced range count of 1, 3 or 7, the partials themselves
          against split_partials_plain), over the serving shapes, a
          long ragged pool, GQA, sliding windows, hymba's shape (25
          query heads over 5 KV heads, a 1024 window, lengths up to
          2048), arctic's (56 over 8, d 128; deepseek-coder-33b's too),
          kimi-k2's (64 over 8, d 112), starcoder2-7b's (36 over 4, d
          128), phi3-medium-14b's (40 over 10, d 128) and the edges of
          the split plan's page ranges (lengths on an edge, a window
          that empties whole ranges, an empty lane);
          then the serve, long and arctic shapes with float8_e4m3fn
          pages (a KV cache stored in fp8) under float32 and bfloat16 q,
          and qwen1.5-0.5b at full width decoding 4 steps through
          ``PagedBackend`` with an fp8 cache against the same run with a
          bf16 cache (``kv_fp8_check``: the reference's criterion from
          ``tests/test_kv_quant.py``, and K1's launch counts).
  k3      K3 ssd_scan (one launch for one chunk; for more, a state
          pass, a pass that carries the state over the chunks and an
          output pass) at hymba's prefill shape, a long case, mamba2-370m's
          prefill (8 prompts, 32 heads of 64, state 128) and a long
          mamba2 case (chunk 64), the reference test shapes, many chunks
          of 24, chunks of one position and mamba2's width over 4 chunks.
  k2      K2 gather_rows bitwise on the embedding tables of every
          served config (hymba, qwen, arctic, whisper, mamba2,
          starcoder2, phi3, deepseek, kimi, paligemma) in bf16 (whisper's,
          mamba2's, starcoder2's and paligemma's also in float32) at 8,
          24, 192 (a dense prefill of 8 prompts) and 8192 ids, each timed
          after an L2 flush beside ``F.embedding``.
  k4      K4 grouped_matmul against its plain twin on the reference test
          shapes and on MARS-sorted, tile-padded routings at arctic's
          decode (w_in and w_out) and prefill and kimi's decode, then on
          the edges of the TMA kernel's cuts (a K and an N that no slab or
          span divides, one expert over consecutive tiles, n_tiles 0 and
          every tile, group ids outside [0, G), K and N not multiples of
          8); padding rows and dead tiles must come out exactly 0.
  k5      K5 flash_attention against its plain twin at whisper-base's
          encoder (8 x 1500 frames, 8 heads of 64, no mask), its
          cross-attention (24 and 1 queries over 1500 frames) and
          decoder prefill, the causal prefills of qwen (16 x 64),
          arctic (56 x 128), kimi (64 x 112), starcoder2 (36 x 128),
          phi3 (40 x 128), paligemma (8 prompts, 8 x 256) and the smoke
          configs (d 16), long causal prefills (8192 tokens, 16 x 128;
          2048 tokens, 8 x 256), the reference test shapes and ragged
          cases with few keys (1, 7 and 24 queries over 40 or 100 keys,
          head dims 16 to 256; one query over 1000 keys at d 256),
          each through the kernel ``split_plan`` picks (wgmma tiles for
          many bf16 queries; 16-row tiles with the keys split over
          blocks and merged in the launch for few; float32).  bfloat16
          is held element by element to a bound derived from the inputs
          (``K5_TOL``) and both dtypes to a gain within 2**-8 of 1; a call
          that also writes the rows' log-sum-exp (the training forward)
          must give the same o bit for bit and an lse within
          ``K5_LSE_TOL`` of the twin's.
          Every kernel is held in float32 and bfloat16 within the stated
          tolerances and timed beside its bound, its plain twin and,
          where one exists, one PyTorch library call.  A device time the
          profiler did not record is retried, then fails the run naming
          the case; it is never read as 0 ms.  K1's, K3's and K5's (and
          B5's and B2's) times come only from a profile that holds every
          launch of the call (``counted_rows``, by the wrapper's counts);
          one short after four tries is timed with CUDA events, and says
          so.
  sim     the paper simulator's two device scans: S1, the MARS cycle
          engine (``csrc/mars_engine.cu``), against its plain twin
          (perm bitwise, stall events, total cycles) on WL1-WL5 at 256
          requests a core (64 cores, 8 ports, n = 16384) and on seeded
          random streams (one page, few pages, many pages, 3 ways, a
          RequestQ of 1024; there also against the OrderedDict oracle),
          and against the oracle on the ablation grid of
          ``benchmarks/ablations.py`` at 128 a core; S2, the FR-FCFS
          DRAM channels (``csrc/dram_channel.cu``), against its twin
          (t_end, n_act, hits a channel) on the baseline and MARS-ordered
          streams of all five workloads at windows 8, 32 and 64, on
          streams shorter than the window, one empty channel and n = 0;
          then the port's ``benchmarks/run.py --smoke`` simulated rows on
          the card against ``results/bench_baseline.json`` (exact), and
          the main path, ``experiment.run_all`` at 256 a core on the
          card, with every count set to 0 just before it (5 S1 and 10
          S2 launches): Fig 7 and Fig 8 per workload and their means,
          which must equal the reference's (29.31 % / 107.71 %).  Each
          kernel is timed at WL1 (device ms, its plain twin's host ms,
          simulated cycles and ns per dependent step).
  serve   ``repro_torch.launch.serve --paged --config <arch>`` at full
          width for qwen1_5_0_5b (24 layers, vocab 151936), hymba_1_5b
          (32 layers, d 1600, SSM heads; also in float32 and through the
          gather decode path) and arctic_480b's first 2 of 35 layers (d
          7168, 128 experts top-2, a dense residual MLP; also through the
          gather decode path), then the arctic and kimi-k2 smoke configs
          in float32, starcoder2_7b (32 layers, d 4608, 36 heads over 4;
          also in float32), phi3_medium_14b (40 layers, d 5120, 40 over
          10), deepseek_coder_33b (all 62 layers, d 7168, 56 over 8) and
          kimi_k2_1t_a32b's first 2 of 61 layers (d 7168, its dense layer
          and one of 384 experts top-8 with a shared expert), then
          qwen1_5_0_5b with ``--tiered-kv`` (64 requests over 32 hot
          prefixes through a pool of 24 blocks; bf16 and float32) and
          with ``--shards 4``, and starcoder2_7b with ``--shards 2
          --tiered-kv`` (every shard on the one card), random
          weights from a seed: served tokens must pass the
          teacher-forced check against the port's dense backend
          (exact argmax in float32, a near-tie margin in bfloat16; each
          run prints its largest deficit), and with every launch count
          set to 0 just before each run, paged_attention's split and
          merge kernels must each have launched once per layer per
          decode step, ssd_scan once per layer per prefill (the
          engine's and the check's; its extra passes twice per layer per
          prefill of more than one chunk: none here), flash_attention once per
          unwindowed layer per prefill,
          gather_rows once per embedding lookup and grouped_matmul three
          times per MoE layer per embedding lookup (a sharded run's
          decode steps are the shards' own, summed).  A tiered run must
          demote and promote, and every promoted block still resident
          must have its staged device mirror pages (and host pool pages)
          equal to its tier payload bit for bit (``mirror_check``; once
          more with the qwen tiered run's pool in float8_e4m3fn,
          ``tier_fp8_check``); a sharded run must dispatch every shard
          before it syncs any, with no synchronizing CUDA call inside a
          shard's dispatch (``dispatch_order_check``, one profiled
          round), and starcoder2's must have the scheduler's tier probe
          wired.  Then qwen1_5_0_5b four times with ``--metrics``
          (an ``obs.Observer`` through the serving stack), with the
          flags of the reference CI's obs smokes: the plain run's, 2
          shards (12 requests, batch 4, 5 tokens, ``--paranoid``), 2
          tiered shards sized to spill (``--pool-blocks 16 --prefixes
          20``, 48 requests) and 3 traffic classes overloaded
          (``--classes 3 --pool-blocks 16``, 24 requests): each passes
          its teacher-forced check and launch counts, then
          ``metrics_check`` reads its ``metrics.json`` and
          ``trace.jsonl`` (under ``chiprun_out/metrics``) with the
          port's code — the ``analysis.races`` replay with no violation
          and a lagged write-back, gauges in range, the phase histograms
          counted, a request's lifecycle in order, the tiers' demote ->
          promote -> decode, the classes' pause/resume and quotas — and
          prints the host phases (step, dispatch, sync, commit; p50,
          p99, mean), the trace's kept and dropped events, the modelled
          row-hit % and tokens/s; the sharded ones pass
          ``dispatch_order_check`` with telemetry on.  The plain qwen
          run is then served warm without and with ``--metrics`` in
          turns for the telemetry's overhead (``metrics_overhead``).
          hymba's bf16 runs
          also report how far their served tokens sit from a float32
          forward on the same weights.  Each run's weights are freed
          before the next.  Each bfloat16 kernel-path run (but the
          starcoder2 sharded one) is then served
          twice more, warm: plain for its wall time, then under
          ``torch.profiler`` for the device's kernel time by kernel and
          its busy share.
  dense   ``repro_torch.launch.serve --config <arch>`` (the dense-backend
          scheduler path, ``mars=False`` then ``mars=True``) at full
          width for whisper_base (6 encoder + 6 decoder layers, d 512,
          1500 stub frames), mamba2_370m (48 layers, d 1024, state 128)
          and paligemma_3b (18 layers, d 2048, 8 heads of 256 over one KV
          head, its text-only decoder as the reference serves it), each
          in bfloat16 and in float32: the served tokens of every batch
          are teacher-forced through ``lm.forward`` on the card
          (paligemma's with an empty image prefix; exact argmax in
          float32, the bf16 near-tie margin with the measured noise term
          otherwise), and with every count set to 0 just before each
          run, flash_attention must have launched (encoder + 2 x decoder
          layers) times per prefill and once per decoder layer per
          decode step (paligemma: once a layer a prefill), ssd_scan once
          per layer per prefill and gather_rows once per embedding
          lookup.  The bf16 runs also report how far their served
          tokens, and their bf16 forward's own argmax, sit from a
          float32 forward on the same weights.  Each bfloat16 run is then served twice more, warm
          and profiled, as above.
  train   the training path (``repro_torch.launch.train``) and its two
          backward kernels.  First, beside the other kernel phases
          (before the serve runs, whose long profiles have been followed
          by profiles short of device events): B5 ``flash_attention_bwd``
          against its plain twin (the explicit formulas, rounding p and
          ds to bf16 where B5 does) in float32 and bfloat16, o and the
          rows' log-sum-exp from K5, at qwen1.5-0.5b's training attention
          (8 x 512, 16 heads of 64, causal), a 4096-token causal case,
          whisper-base's encoder (8 x 1500, 8 x 64, no mask),
          cross-attention (512 over 1500) and decoder, and head dim 128
          (``B5_TOL``, in bf16 plus the rounding flips of p and ds,
          ``b5_bounds``), and in bf16 B5's and SDPA backward's distance
          from the unrounded float32 twin; B2 ``embedding_grad_scatter``
          on qwen's and whisper's tables with TokenStream's zipf ids and
          uniform ids (8 x 512), and its worst cases (``B2_WORST``: one id
          for all 4096 tokens, widths 1000 and 999), bitwise against its
          twin on host copies and within ``B2_TOL`` of it on the card;
          each timed (from a profile that holds every launch) beside its
          bound, its twin and the library call (SDPA's backward,
          ``F.embedding``'s backward), and K5 at each B5 shape with and
          without the lse output.  After the
          dense runs: one float32 step of qwen1.5-0.5b at full width
          (batch 2 x 128), the loss and every gradient leaf on the card
          against the same step on host copies, and remat on against
          off; ``launch.train`` on CUDA must refuse hymba-1.5b,
          mamba2-370m and arctic-480b (K3's and K4's backward kernels do
          not exist yet), and K3's and K4's wrappers must raise for an
          input that needs a gradient without launching
          (``kernel_grad_refusals``); then ``launch.train`` in bf16 at
          full width with every count set to 0 just before it: qwen1.5-0.5b 30
          steps of 8 x 512, a checkpoint every 10, and whisper-base 12
          steps (checkpoint every 4; stub frames, ``--frontend stub``:
          the reference's zero frames train nothing at its width):
          finite losses, the last below the first, K5 once per
          attention a step (24; whisper 18), B5 three times as often,
          K2 and B2 once a step; the same run killed after step 19
          (whisper 7) and resumed with ``--resume`` must end at the
          uninterrupted last loss within rtol 1e-4; prints step ms,
          tokens/s and peak allocated memory, then one warm step of
          each under ``torch.profiler`` (device time by kernel and
          kind, busy share).

Prints the card's name and power limit (as ``nvidia-smi`` gives them), a
``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``; the full record goes to ``chiprun_out/
chip_smoke.json``.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS = {"float32": 67e12,        # H100 SXM, outside the tensor cores
            "bfloat16": 989e12}      # H100 SXM tensor cores, dense
TOL = {"float32": dict(o=(1e-4, 1e-4), ml=(1e-4, 1e-4)),
       "bfloat16": dict(o=(2e-2, 0.0), ml=(1e-5, 1e-3))}  # (atol, rtol)
# ssd_scan against its plain twin, (atol, rtol), for float32 and bfloat16
# inputs alike: both upcast the same values and work in f32, and differ
# only in summation order (sums of up to 64 + 128 terms a chunk, the
# state carried over up to 64 chunks)
SSD_TOL = (1e-3, 1e-3)
# flash_attention against its plain twin.  float32, (atol, rtol): the
# same f32 products and exponentials, summed in another order (32 keys a
# step under a running maximum, against one softmax) and taken as exp2 of
# log2(e)-scaled scores: differences near 1e-6 of |o|, which stays below
# max |v| (about 5 for unit normal inputs).  bfloat16, element by element
# (``k5_bf16_tol``): each side rounds every probability to bf16 before
# the product with v (the kernel at its running maximum, the twin at the
# final one), an error of at most u = 2**-8 of that probability, so the
# two sums differ by at most 2 u (P|v|), where P|v| is the twin's
# softmax applied to |v| in f32; each side then rounds o to bf16, at most
# u of its |o|; and both sum up to Sk f32 terms (2**-24 each).  So
#   |got - want| <= 2 u (P|v|) + u (|got| + |want|) + Sk 2**-23 (P|v|).
# With Sk 1500 and unit normal v that is about 6e-3 while |o| is near
# 0.04, so a bound per element cannot see a defect that scales o by a
# few percent; both dtypes are also held to a gain: sum(got want) /
# sum(want^2) within 2**-8 of 1 (round to nearest is unbiased, so
# rounding moves the gain by about u / sqrt(elements), far below 2**-8,
# while a dropped tail mask at Sk 1500 moves it by 1.4%).  Where
# ``split_plan`` splits the keys over blocks, each range rounds its
# probabilities at its own running maximum and the merge scales them by
# exp(m_range - m) in f32: each p is still rounded once, with a relative
# error of at most u (and 2**-24 from the f32 scaling), so the same bound
# holds, unwidened.
K5_TOL = {"float32": (1e-4, 1e-4)}
K5_GAIN_TOL = 2.0 ** -8
# A call that also writes the rows' log-sum-exp (the training forward)
# must give the same o bit for bit, and its lse must be the twin's
# (``flash_attention_plain(..., return_lse=True)``: logsumexp of the same
# f32 scores) within 2e-4: the kernel sums up to 8192 exponentials in
# another order (relative 1e-4 at most in l, so in log l) and takes its
# maximum in log2 units (m ln 2 loses 2**-24 of |m|).
K5_LSE_TOL = 2e-4
# K5 cases: (name, B, Sq, Sk, H, D, causal).  whisper-base serves 8
# prompts of 24 tokens over 1500 stub frames: its encoder, its
# cross-attention at prefill and at decode (one query), its decoder's
# prefill; the causal 24-token prefills of qwen1.5-0.5b, arctic-480b
# (and deepseek-coder-33b: 56 x 128 too), kimi-k2, starcoder2-7b,
# phi3-medium-14b, paligemma-3b's dense batch of 8 (d 256, 8 heads after
# its one KV head is repeated) and the smoke configs (d 16); a long
# prefill at d 128 and at d 256 (d 256 runs the 16-row tiles at every
# length); the reference's kernel test shapes; and ragged cases with few
# keys at every head dim, where the keys past Sk in the last tile (24 of
# 64 at Sk 40, 28 at Sk 100) would move o by tens of percent if their
# mask were lost (at d 256 also one query over 1000 keys, cut into key
# ranges merged in the launch).
K5_CASES = [("whisper_encoder", 8, 1500, 1500, 8, 64, False),
            ("whisper_cross_prefill", 8, 24, 1500, 8, 64, False),
            ("whisper_cross_decode", 8, 1, 1500, 8, 64, False),
            ("whisper_decoder_prefill", 8, 24, 24, 8, 64, True),
            ("qwen_prefill", 1, 24, 24, 16, 64, True),
            ("arctic_prefill", 1, 24, 24, 56, 128, True),
            ("kimi_prefill", 1, 24, 24, 64, 112, True),
            ("starcoder2_prefill", 1, 24, 24, 36, 128, True),
            ("phi3_prefill", 1, 24, 24, 40, 128, True),
            ("paligemma_prefill", 8, 24, 24, 8, 256, True),
            ("smoke_prefill", 1, 24, 24, 4, 16, True),
            ("long_prefill", 1, 8192, 8192, 16, 128, True),
            ("long_d256", 1, 2048, 2048, 8, 256, True),
            ("ref_a", 1, 128, 128, 2, 64, True),
            ("ref_b", 2, 256, 256, 4, 64, True),
            ("ref_c", 1, 512, 512, 1, 128, True),
            ("ref_noncausal", 1, 128, 128, 2, 64, False),
            ("ragged_1x40", 2, 1, 40, 4, 64, False),
            ("ragged_7x40", 2, 7, 40, 4, 64, False),
            ("ragged_24x100", 2, 24, 100, 4, 64, False),
            ("ragged_d16_24x40", 1, 24, 40, 4, 16, False),
            ("ragged_d112_7x100", 1, 7, 100, 4, 112, False),
            ("ragged_d128_24x40", 1, 24, 40, 4, 128, False),
            ("ragged_d256_7x100", 1, 7, 100, 4, 256, False),
            ("ragged_d256_1x1000", 2, 1, 1000, 4, 256, False),
            ("ragged_causal_100", 1, 100, 100, 4, 64, True)]
OUT_DIR = ROOT / "chiprun_out"
# serve runs, each its own path for the launch counts: (config, extra
# flags).  A config serves in its own bfloat16 through the kernels unless
# a flag says otherwise, and those runs are profiled.  In float32 the
# teacher-forced check is exact (the served tokens must be the dense
# argmax).  The gather runs decode through the dense math over a
# gathered view: their largest deficit in bfloat16 is the noise floor the
# kernel path's is read against.  arctic-480b serves its first 2 of 35
# layers at published width (``--layers 2``: one card holds two); the
# MoE smoke configs in float32 are the exact gates of the MoE path
# through K4 (their d_head of 16 is outside K1, so they decode through
# the gathered view; kimi's covers blocks_dense and the shared expert).
# The dense GQA models at d 128 serve at full width: starcoder2-7b
# (LayerNorm, GELU, QKV bias; 36 heads over 4) in bf16 and in float32
# (about 30 GB: the exact gate of K1 and K5 at n_rep 9), phi3-medium-14b
# (40 over 10) and deepseek-coder-33b, all 62 layers (66.7 GB in bf16,
# 56 over 8); kimi-k2 serves its first 2 of 61 layers at published
# width (its dense layer and one of 384 experts top-8 with a shared
# expert, 39 GB).
# The tiered runs serve 64 requests over 32 hot prefixes through a pool of
# 24 blocks (8 lanes of 2 blocks leave 8 to cache 32 prefixes): prefix
# blocks are evicted, demoted to the spill tiers and promoted back (about
# 32 each, 50 MB of qwen1.5-0.5b's 1.57 MB blocks).  The sharded runs put
# all their shards on the one card: qwen1.5-0.5b over 4 shards of 64
# blocks, starcoder2-7b (GQA at n_rep 9) over 2 shards of 12 with tiers.
ARCTIC = ("--layers", "2")
TIERED = ("--tiered-kv", "--pool-blocks", "24", "--prefixes", "32",
          "--requests", "64")
SHARDED = ("--shards", "4")
SHARDED_TIERED = ("--shards", "2") + TIERED
# The telemetry runs (``--metrics``): qwen1.5-0.5b at full width with an
# ``obs.Observer`` wired through the serving stack, each with the flags of
# one of the reference CI's four obs smokes (less ``--smoke``): the plain
# run's, the pipelined 2-shard run, the tiered 2-shard run sized to spill
# and the overloaded 3-class run.  Each writes its snapshot and trace
# under ``chiprun_out/metrics/<run>`` and ``metrics_check`` reads them
# with the port's own code.  Not profiled: the profiler would inflate the
# host phases the runs measure.
METRICS_DIR = "chiprun_out/metrics"
METRICS_SMOKES = {
    "plain": (),
    "pipeline": ("--shards", "2", "--requests", "12", "--batch", "4",
                 "--new-tokens", "5", "--paranoid"),
    "tiered": ("--shards", "2", "--tiered-kv", "--pool-blocks", "16",
               "--prefixes", "20", "--requests", "48", "--batch", "4",
               "--new-tokens", "6", "--paranoid"),
    "classes": ("--classes", "3", "--pool-blocks", "16", "--requests",
                "24", "--batch", "4", "--new-tokens", "6", "--paranoid"),
}


def metrics_flags(tag: str, root: str = METRICS_DIR) -> tuple:
    """The ``METRICS_SMOKES`` run ``tag`` with ``--metrics``, writing
    under ``root/tag``."""
    return METRICS_SMOKES[tag] + ("--metrics", "--metrics-path",
                                  f"{root}/{tag}")


RUNS = (("qwen1_5_0_5b", ()), ("hymba_1_5b", ()),
        ("hymba_1_5b", ("--dtype", "float32")),
        ("hymba_1_5b", ("--no-kernel-decode",)),
        ("arctic_480b", ARCTIC),
        ("arctic_480b", ARCTIC + ("--no-kernel-decode",)),
        ("arctic_480b", ("--smoke", "--dtype", "float32",
                         "--no-kernel-decode")),
        ("kimi_k2_1t_a32b", ("--smoke", "--dtype", "float32",
                             "--no-kernel-decode")),
        ("starcoder2_7b", ()), ("starcoder2_7b", ("--dtype", "float32")),
        ("phi3_medium_14b", ()), ("deepseek_coder_33b", ()),
        ("kimi_k2_1t_a32b", ("--layers", "2")),
        ("qwen1_5_0_5b", TIERED),
        ("qwen1_5_0_5b", TIERED + ("--dtype", "float32")),
        ("qwen1_5_0_5b", SHARDED),
        ("starcoder2_7b", SHARDED_TIERED)) + tuple(
    ("qwen1_5_0_5b", metrics_flags(tag)) for tag in METRICS_SMOKES)
# flags that take a run off the profiled bf16 kernel path (and the
# telemetry runs); the starcoder2 sharded run is not profiled either (two
# more 7B serve runs for a breakdown the qwen runs give)
UNPROFILED = {"--dtype", "--no-kernel-decode", "--smoke", "--metrics"}
UNPROFILED_RUNS = {"starcoder2_7b " + " ".join(SHARDED_TIERED)}
# dense-backend runs (``serve.main`` without --paged): (config, flags);
# the bf16 ones are profiled.  paligemma-3b serves its text-only decoder
# (d 256 heads, MQA), as the reference's ``main`` does
DENSE_RUNS = (("whisper_base", ()), ("whisper_base", ("--dtype", "float32")),
              ("mamba2_370m", ()), ("mamba2_370m", ("--dtype", "float32")),
              ("paligemma_3b", ()), ("paligemma_3b", ("--dtype", "float32")))


def run_name(arch: str, flags=()) -> str:
    return " ".join((arch,) + tuple(flags))


def serve_args(arch: str, flags=()) -> list:
    return ["--paged", *dense_args(arch, flags)]


def dense_args(arch: str, flags=()) -> list:
    return ["--config", arch, "--requests", "16", "--batch", "8",
            "--device", "cuda", *flags]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` after
    warm-up.  At small shapes this includes the host's launch overhead
    (the card waits for the enqueue)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cold_ms(torch, fn, reps: int, flush) -> float:
    """Device time of one call of ``fn`` with a cold L2, as a caller that
    reads fresh rows finds it: before each call the card writes ``flush``
    (larger than the 50 MB L2) and then spins long enough that the host
    has enqueued the call before the card reaches it, so the CUDA events
    around the call bracket its kernels alone.  Median over ``reps``
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)       # ~0.5 ms at the H100's clock
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_rows(prof) -> list:
    """Device-side rows (kernels, copies) of a finished ``torch.profiler``
    run: name, summed device ms and count, longest first (``raw_rows``)."""
    return raw_rows(prof)[0]


class Unread(RuntimeError):
    """The profiler recorded no device time for a call that launches
    kernels."""


def device_profile(fn, reps: int, case: str = "", need=(),
                   tries: int = 4) -> list:
    """``profile_rows`` of ``fn``, retried while the profile holds no
    device row or lacks a kernel named in ``need`` (a profile can come
    back empty, most often the first of a process); after ``tries`` such
    profiles the case is reported unread (``Unread``, naming it), never
    read as 0 ms."""
    for _ in range(tries):
        rows = profile_rows(fn, reps)
        if rows and all(rows_ms(rows, key) > 0 for key in need):
            return rows
    raise Unread(f"{case or fn}: torch.profiler recorded no device time"
                 f"{' for ' + ', '.join(need) if need else ''} in {tries} "
                 f"profiles of {reps} calls")


def device_ms(fn, reps: int, case: str = "", tries: int = 4) -> float:
    """Device time of one call of ``fn``: the summed time of every kernel
    it launches (``torch.profiler``), over ``reps`` calls after one
    warm-up call.  Host launch overhead is not in it.  Read through
    ``device_profile``, so never 0 ms."""
    return sum(r["ms"] for r in device_profile(fn, reps, case, tries=tries))


def launches_of(fn, *counts) -> int:
    """Kernel launches of one call of ``fn`` by the wrappers' own counts:
    ``counts`` are (wrapper, attribute) pairs, as ``kernel_counters``
    gives them; ``fn`` is called once."""
    before = sum(getattr(w, a) for w, a in counts)
    fn()
    return sum(getattr(w, a) for w, a in counts) - before


def counted_rows(fn, reps: int, case: str, key: str, per_call: int,
                 tries: int = 4, tag: str = "[kernel]"):
    """``device_profile`` rows of ``fn`` from a profile that holds all of
    its kernel launches: ``per_call`` launches a call of kernels whose
    name holds ``key``.  A profile short of them (the profiler has been
    seen to drop device events, late in a long process most of all) is
    retried; after ``tries`` short ones, None: a short profile is never
    read."""
    for _ in range(tries):
        rows = device_profile(fn, reps, case, need=(key,))
        calls = sum(r["calls"] for r in rows if key in r["name"])
        if calls == per_call * reps:
            return rows
        print(f"{tag} {case}: the profile holds {calls} launches of {key}, "
              f"not {per_call * reps} (" + ", ".join(
                  f"{r['name'][:60]} x{r['calls']}" for r in rows)
              + "); profiled again")
    return None


def counted_ms(fn, reps: int, case: str, key: str, per_call: int,
               tries: int = 4, tag: str = "[kernel]") -> float:
    """``device_ms`` of ``fn`` read from ``counted_rows``; when every
    profile came back short, the time is read with CUDA events over
    ``reps`` calls instead (``time_ms``: the host's launch is in it, so it
    can only read slower), and said so."""
    rows = counted_rows(fn, reps, case, key, per_call, tries, tag)
    if rows is not None:
        return sum(r["ms"] for r in rows)
    print(f"{tag} {case}: {tries} profiles short of {key}'s launches; "
          f"timed with CUDA events instead")
    return time_ms(fn, reps)


def warm_profiler(torch) -> None:
    """One throwaway profile of a small kernel, so that the profiler's
    first session of the process, whose device rows have been seen to
    come back empty, reads no case."""
    x = torch.ones(1 << 20, device="cuda")
    profile_rows(lambda: x.mul_(1.0), 5)


def make_case(gen, *, B, H, Hkv, D, page, L, P, n_pages, lengths, dtype,
              kv_dtype=None):
    """Random paged-attention operands on the card: distinct blocks per
    lane from a pool of P blocks, the given per-lane lengths; the pages in
    ``kv_dtype`` (default: q's)."""
    import torch
    dev = gen.device
    kvd = kv_dtype or dtype
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(L, P, page, Hkv, D, generator=gen, device=dev).to(kvd)
    vp = torch.randn(L, P, page, Hkv, D, generator=gen, device=dev).to(kvd)
    kn = torch.randn(B, Hkv, D, generator=gen, device=dev).to(dtype)
    vn = torch.randn(B, Hkv, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * n_pages]
    pt = perm.reshape(B, n_pages).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, kn, vn, pt, ln


def close(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def kernel_phase(torch, gen):
    """K1's split and merge kernels against their plain twins: the state
    of ``paged_attention`` against the oracle, ``decode_attend`` against
    ``decode_attend_plain`` on the card and against the same call on host
    copies, the merge kernel alone against ``merge_partials_plain`` on the
    split kernel's partials, and (with a forced range count) the partials
    themselves against ``split_partials_plain``."""
    from repro_torch.kernels.paged_attention import paged_attention as pa_mod
    pa, plain = pa_mod.paged_attention, pa_mod.paged_attention_plain
    sms = torch.cuda.get_device_properties(gen.device).multi_processor_count
    cases = []
    for dtype in ("float32", "bfloat16"):
        # serving shapes of qwen1.5-0.5b: 8 lanes, 16 heads (kv 16), d 64
        serve_len = [int(x) for x in torch.randint(
            1, 8 * 16, (8,), generator=gen, device=gen.device)]
        cases.append(("serve", dtype, dict(B=8, H=16, Hkv=16, D=64, page=16,
                                           L=24, P=256, n_pages=8,
                                           lengths=serve_len), 7, 0))
        # long ragged pool: 2048 blocks, lengths in [0, 4096], one empty
        long_len = [int(x) for x in torch.randint(
            0, 4097, (8,), generator=gen, device=gen.device)]
        long_len[3] = 0
        cases.append(("long", dtype, dict(B=8, H=16, Hkv=16, D=64, page=16,
                                          L=2, P=2048, n_pages=256,
                                          lengths=long_len), 1, 0))
        # GQA: n_rep 2 and 8, and 32 (two blocks of <= 16 query heads)
        for H, Hkv, D, page in ((8, 4, 128, 8), (16, 2, 64, 4),
                                (32, 1, 128, 16)):
            cases.append((f"gqa{H // Hkv}", dtype,
                          dict(B=4, H=H, Hkv=Hkv, D=D, page=page, L=3, P=64,
                               n_pages=12, lengths=[0, 5, 29, page * 12]),
                          2, 0))
        for window in (1, 64):
            cases.append((f"window{window}", dtype,
                          dict(B=8, H=16, Hkv=16, D=64, page=16, L=4,
                               P=512, n_pages=32,
                               lengths=[0, 1, 63, 64, 65, 200, 511, 512]),
                          3, window))
        # hymba's shape: 25 query heads over 5 KV heads (n_rep 5), d 64,
        # pages of 16, its 1024-token window bound by lengths up to 2048
        cases.append(("hymba", dtype,
                      dict(B=8, H=25, Hkv=5, D=64, page=16, L=2, P=1100,
                           n_pages=128,
                           lengths=[0, 1, 1023, 1024, 1025, 1500, 2047,
                                    2048]),
                      1, 1024))
        # arctic-480b's shape: 56 query heads over 8 KV heads (n_rep 7),
        # d 128, no window, lengths up to 2048, a 2-layer pool
        cases.append(("arctic", dtype,
                      dict(B=8, H=56, Hkv=8, D=128, page=16, L=2, P=1100,
                           n_pages=128,
                           lengths=[0, 1, 17, 255, 1024, 1500, 2047,
                                    2048]),
                      1, 0))
        # kimi-k2's shape: 64 query heads over 8 KV heads (n_rep 8), d 112
        cases.append(("kimi", dtype,
                      dict(B=8, H=64, Hkv=8, D=112, page=16, L=2, P=1100,
                           n_pages=128,
                           lengths=[0, 1, 17, 255, 1024, 1500, 2047,
                                    2048]),
                      1, 0))
        # starcoder2-7b's (36 over 4, n_rep 9) and phi3-medium-14b's (40
        # over 10, n_rep 4) shapes at d 128: a KV head's query group
        # fills 9 and 4 of the 16 rows a block holds (deepseek-coder-33b's
        # 56 over 8 is arctic's)
        for name, H, Hkv in (("starcoder2", 36, 4), ("phi3", 40, 10)):
            cases.append((name, dtype,
                          dict(B=8, H=H, Hkv=Hkv, D=128, page=16, L=2,
                               P=1100, n_pages=128,
                               lengths=[0, 1, 17, 255, 1024, 1500, 2047,
                                        2048]),
                          1, 0))
        # the edges of the split plan's page ranges on this card: lengths
        # on, one short of and one past a range edge, one lane at 0; a
        # window whose start falls on range edges and empties the ranges
        # before it; and forced range counts (1: one block walks all of a
        # lane's pages; 3 and 7: ranges that are not whole ring stages)
        edge = dict(B=8, H=16, Hkv=2, D=128, page=16, L=2, P=600,
                    n_pages=64)
        span = pa_mod.split_plan(64, 16, 8, 2, 8, sms)[1] * 16
        S = 64 * 16
        edge_len = [0, span, span - 1, span + 1, min(2 * span, S), S,
                    S - 1, min(3 * span + 5, S)]
        cases.append(("split_edges", dtype, dict(edge, lengths=edge_len),
                       1, 0))
        win = 100
        cases.append(("split_window", dtype,
                      dict(edge, lengths=[S, min(5 * span + win - 1, S),
                                          win - 1, win, win + 1, 0, 1,
                                          min(2 * span + win - 1, S)]),
                      1, win))
        for ns in (1, 3, 7):
            cases.append((f"n_split{ns}", dtype,
                          dict(edge, lengths=edge_len), 0, 0, ns))
        # a KV cache stored in float8_e4m3fn (cfg.kv_dtype): the serve,
        # long and arctic shapes with fp8 pages, q and the token in dtype
        for name in ("serve", "long", "arctic"):
            base = next(c for c in cases if c[0] == name and c[1] == dtype)
            cases.append((f"{name}_fp8", dtype,
                          dict(base[2], kv_dtype=torch.float8_e4m3fn),
                          base[3], base[4]))
    results, max_err, merge_err = [], 0.0, 0.0
    timed = {}
    for name, dtype, shp, layer, window, *forced in cases:
        n_split = forced[0] if forced else None
        q, kp, vp, kn, vn, pt, ln = make_case(gen, dtype=getattr(torch, dtype),
                                              **shp)
        kw = dict(layer=layer, window=window)
        # the split kernel's partials (a forced range count, or the plan's)
        parts = pa_mod.paged_attention_partials(q, kp, vp, pt, ln,
                                                n_split=n_split, **kw)
        if n_split is None:
            o, m, l = pa(q, kp, vp, pt, ln, return_state=True, **kw)
            d = pa_mod.decode_attend(q, kn, vn, kp, vp, pt, ln, **kw)
        else:
            o, m, l = pa_mod.merge_partials(*parts, q)
            d = pa_mod.merge_partials(*parts, q, kn, vn)
        torch.cuda.synchronize()
        o2, m2, l2 = plain(q, kp, vp, pt, ln, **kw)
        tol = TOL[dtype]
        ok_o, e_o = close(o, o2, *tol["o"])
        ok_m, e_m = close(m, m2, *tol["ml"])
        ok_l, e_l = close(l, l2, *tol["ml"])
        ok_dp, e_dp = close(d, pa_mod.decode_attend_plain(
            q, kn, vn, kp, vp, pt, ln, **kw), *tol["o"])
        # the same call on host copies, where decode_attend runs its plain
        # twin on the CPU
        d2 = pa_mod.decode_attend(*(t.cpu() for t in (q, kn, vn, kp, vp, pt,
                                                      ln)), **kw)
        ok_d, e_d = close(d.cpu(), d2, *tol["o"])
        # the merge kernel alone, both modes, on the split kernel's partials
        mo, mm, ml = pa_mod.merge_partials(*parts, q)
        md = pa_mod.merge_partials(*parts, q, kn, vn)
        torch.cuda.synchronize()
        po, pm, pl = pa_mod.merge_partials_plain(*parts, q)
        pd = pa_mod.merge_partials_plain(*parts, q, kn, vn)
        ok_mg = [close(mo, po, *tol["o"]), close(md, pd, *tol["o"]),
                 close(mm, pm, *tol["ml"]), close(ml, pl, *tol["ml"])]
        e_mg = max(e for _, e in ok_mg)
        ok_all = ok_o and ok_m and ok_l and ok_d and ok_dp \
            and all(k for k, _ in ok_mg)
        e_part = None
        if n_split is not None:       # the split kernel's partials alone
            pacc, pm_, pl_ = pa_mod.split_partials_plain(
                q, kp, vp, pt, ln, n_split=n_split, **kw)
            acc, pmk, plk = parts
            norm = [(a / b.clamp_min(1e-30)[..., None]) for a, b in
                    ((acc, plk), (pacc, pl_))]
            checks = [close(norm[0], norm[1], *tol["o"]),
                      close(pmk, pm_, *tol["ml"]), close(plk, pl_,
                                                         *tol["ml"])]
            e_part = max(e for _, e in checks)
            ok_all = ok_all and all(k for k, _ in checks)
        line = (f"[kernel] {name:12s} {dtype:8s} o_err={e_o:.3e} "
                f"m_err={e_m:.3e} l_err={e_l:.3e} decode_err={e_d:.3e} "
                f"decode_vs_plain_on_card={e_dp:.3e} merge_err={e_mg:.3e} "
                + (f"partials_err={e_part:.3e} " if e_part is not None
                   else "")
                + f"n_split={n_split or 'plan'} tol(o atol,rtol)={tol['o']} "
                f"tol(m,l)={tol['ml']} {'ok' if ok_all else 'MISMATCH'}")
        print(line)
        results.append(dict(case=name, dtype=dtype, o_err=e_o, m_err=e_m,
                            l_err=e_l, decode_err=e_d,
                            decode_plain_err=e_dp, merge_err=e_mg,
                            partials_err=e_part, n_split=n_split,
                            ok=ok_all))
        max_err = max(max_err, e_o, e_d, e_dp)
        merge_err = max(merge_err, e_mg)
        if name in ("serve", "long", "hymba", "arctic", "kimi", "starcoder2",
                    "phi3", "serve_fp8", "long_fp8", "arctic_fp8"):
            timed[(name, dtype)] = (q, kp, vp, kn, vn, pt, ln, layer, window,
                                    shp)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain twin: {bad}")
    return results, max_err, merge_err, timed


def kv_fp8_check(torch, arch: str = "qwen1_5_0_5b") -> dict:
    """A KV cache stored in float8_e4m3fn at full width: ``arch`` (random
    weights from seed 0) takes 4 prompt tokens, then 4 decode steps through
    ``PagedBackend`` in kernel mode, once with the cache in its compute
    dtype and once in fp8, on the same weights.  Held to the reference's
    criterion (``tests/test_kv_quant.py``): the last step's top-1 token is
    kept unless the bf16 run's top two are within twice the largest logit
    change (then fp8's top-1 is among bf16's top two), and the logits
    agree to atol = rtol = 0.35.  K1 (split and merge) must launch once a
    layer a decode step in each run."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get(arch)
    params = lm.init(cfg, torch.Generator("cuda").manual_seed(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (1, 8)) \
        .astype(np.int32)
    counters = kernel_counters()
    logits, launches = {}, {}
    for kv in ("", "float8_e4m3fn"):
        c = dataclasses.replace(cfg, kv_dtype=kv)
        backend = lm.init_cache(c, 1, 16, kind="paged", device="cuda")
        reset_counts(counters)
        with torch.no_grad():
            _, backend = lm.prefill(params, c, tokens[:, :4], backend=backend)
            for t in range(4, 8):
                lg, backend = lm.decode_step(params, c, tokens[:, t:t + 1],
                                             backend)
        torch.cuda.synchronize()
        name = kv or cfg.compute_dtype
        launches[name] = read_counts(counters)
        if backend.pool.k_pages.dtype != c.kvdtype:
            raise AssertionError(f"{arch} {name}: pool holds "
                                 f"{backend.pool.k_pages.dtype}")
        logits[name] = lg[0, 0].float().cpu().numpy()
        backend.release()
    a, b = logits[cfg.compute_dtype], logits["float8_e4m3fn"]
    top = np.sort(a)
    gap, dev = float(top[-1] - top[-2]), float(np.abs(a - b).max())
    kept = int(np.argmax(a)) == int(np.argmax(b)) if gap > 2 * dev \
        else int(np.argmax(b)) in np.argsort(a)[-2:]
    close_ok = bool(np.allclose(b, a, rtol=0.35, atol=0.35))
    want = cfg.n_layers * 4
    k1_ok = all(n["paged_attention"] == want
                and n["paged_attention_merge"] == want
                for n in launches.values())
    ok = kept and close_ok and k1_ok and bool(np.isfinite(b).all())
    print(f"[kernel] kv fp8 {arch} full width: 4 prompt tokens + 4 paged "
          f"decode steps, {cfg.compute_dtype} KV vs float8_e4m3fn KV: top-1 "
          f"{int(np.argmax(a))} / {int(np.argmax(b))} (bf16 top-2 gap "
          f"{gap:.4g}, largest logit change {dev:.4g}), allclose(0.35, "
          f"0.35) {close_ok}; K1 launches "
          + ", ".join(f"{k}: {n['paged_attention']} + "
                      f"{n['paged_attention_merge']}"
                      for k, n in launches.items())
          + f" (want {want} + {want}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"fp8 KV decode of {arch} fails the criterion "
                             f"or its launch counts: {launches}")
    return dict(arch=arch, top1=[int(np.argmax(a)), int(np.argmax(b))],
                gap=gap, max_logit_change=dev, launches=launches)


MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


def profile_rows(fn, reps: int) -> list:
    """``device_rows`` of ``reps`` calls of ``fn`` after one warm-up call,
    each row's ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a marker kernel first: the profiler has dropped the first kernel
        # of a window (B5's pre-pass, 29 of 30 launches, in every case
        # profile of a timing run on the H100); its row is left out
        torch.cuda._sleep(1)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [dict(r, ms=r["ms"] / reps) for r in device_rows(prof)
            if MARKER not in r["name"]]


def ms_txt(ms) -> str:
    """A time as printed: 4 decimals, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f}"


def rows_ms(rows, key: str) -> float:
    return sum(r["ms"] for r in rows if key in r["name"])


def time_case(torch, F, ops, case: str, dtype: str, flush):
    """K1 (split + merge, each also alone), its plain twin and SDPA (over
    pre-gathered keys) at one case, as device time per call (warm L2, and
    CUDA events around one call after an L2 flush) and as event time per
    call with the host's launch; ``decode_attend`` and its merge pass;
    bound from the bytes and operations this case's data needs (under a
    window, only the positions and pages inside it)."""
    from repro_torch.kernels.paged_attention import paged_attention as pa_mod
    q, kp, vp, kn, vn, pt, ln, layer, window, shp = ops
    B, H, D = q.shape
    Hkv, page = shp["Hkv"], shp["page"]
    eb, kvb = q.element_size(), kp.element_size()
    lens = [int(x) for x in ln]
    # valid positions [lo, len) with lo = len - window + 1 under a window
    los = [max(n - window + 1, 0) if window else 0 for n in lens]
    valid = sum(n - lo for n, lo in zip(lens, los))
    pages = sum((n - 1) // page - lo // page + 1
                for n, lo in zip(lens, los) if n > lo)
    bytes_moved = (2 * valid * Hkv * D * kvb         # valid K and V rows
                   + 2 * B * H * D * eb              # q in, o out
                   + 2 * B * H * 4                   # m, l out
                   + pages * 4 + B * 4)              # page-table entries, lengths
    ops_count = 4 * valid * H * D                    # q.k and p.v
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3
    kw = dict(layer=layer, window=window)

    def kern():
        pa_mod.paged_attention(q, kp, vp, pt, ln, return_state=True, **kw)

    def plain():
        pa_mod.paged_attention_plain(q, kp, vp, pt, ln, **kw)

    def decode():
        pa_mod.decode_attend(q, kn, vn, kp, vp, pt, ln, **kw)

    parts = pa_mod.paged_attention_partials(q, kp, vp, pt, ln, **kw)

    def merge_plain():
        pa_mod.merge_partials_plain(*parts, q, kn, vn)
    # the merge pass in decode mode reads the partials, q and the token's
    # K/V, and writes o
    n_split = parts[0].shape[2]
    merge_bytes = (B * H * n_split * (D + 2) * 4 + 2 * B * H * D * eb
                   + 2 * B * Hkv * D * eb)
    # library yardstick: SDPA over the same keys gathered contiguously
    # (and, for fp8 pages, widened to q's dtype) beforehand (excluded);
    # lanes as the batch, the same valid-position mask; never called by
    # the port
    S = pt.shape[1] * page
    kg = kp[layer][pt.long()].reshape(B, S, Hkv, D).transpose(1, 2) \
        .to(q.dtype).contiguous()
    vg = vp[layer][pt.long()].reshape(B, S, Hkv, D).transpose(1, 2) \
        .to(q.dtype).contiguous()
    pos = torch.arange(S, device=q.device)[None, :]
    lo = torch.tensor(los, device=q.device)[:, None]
    mask = ((pos < ln[:, None].long()) & (pos >= lo))[:, None, None, :]
    q4 = q[:, :, None, :]
    if Hkv != H:       # GQA: K/V heads expanded beforehand, not timed
        kg = kg.repeat_interleave(H // Hkv, dim=1)
        vg = vg.repeat_interleave(H // Hkv, dim=1)

    def lib():
        F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    # each profile must hold every split and merge launch (by the
    # wrapper's counts of one call); one still short after its retries
    # is timed with CUDA events, its split and merge not measured
    counts = ((pa_mod.paged_attention, "launches"),
              (pa_mod.paged_attention, "merge_launches"))
    timed = {}
    for tag, fn in (("", kern), ("decode_", decode)):
        name = f"{'decode_attend' if tag else 'paged_attention'} {case}"
        rows = counted_rows(fn, 50, name, "paged_attention_",
                            launches_of(fn, *counts))
        if rows is None:
            print(f"[kernel] {name}: profiles short of its launches; timed "
                  f"with CUDA events, split and merge not measured")
            timed[tag] = (time_ms(fn, 50), None, None)
        else:
            timed[tag] = (sum(r["ms"] for r in rows),
                          rows_ms(rows, "paged_attention_split"),
                          rows_ms(rows, "paged_attention_merge"))
    return dict(ms=timed[""][0], split_ms=timed[""][1],
                merge_ms=timed[""][2], decode_ms=timed["decode_"][0],
                decode_merge_ms=timed["decode_"][2],
                merge_plain_ms=device_ms(merge_plain, 10,
                                         f"merge twin {case}"),
                merge_bound_ms=merge_bytes / HBM_BYTES_PER_S * 1e3,
                n_split=n_split,
                plain_ms=device_ms(plain, 10, f"paged_attention twin {case}"),
                library_ms=device_ms(lib, 50, f"K1 SDPA {case}"),
                cold_ms=cold_ms(torch, kern, 20, flush),
                cold_library_ms=cold_ms(torch, lib, 20, flush),
                event_ms=time_ms(kern, 50),
                decode_event_ms=time_ms(decode, 50),
                plain_event_ms=time_ms(plain, 10),
                library_event_ms=time_ms(lib, 50),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, ops=ops_count, valid_positions=valid)


# K3 cases: (name, B, S, H, P, N, chunk).  hymba's prefill: one request
# of 24 prompt tokens under chunk 64 (one chunk of 24, one launch); a
# long case of 64 chunks; mamba2-370m's prefill: a batch of 8 prompts of
# 24 tokens, 32 heads of 64, state 128, and a long mamba2 case (chunk 64:
# 145 KB of shared memory a block of its output pass); the shapes of the
# reference's kernel tests; then cases the chunks-in-parallel design can
# get wrong: many chunks of a length that is not a power of two (96 =
# 4 x 24), chunks of one position, and mamba2's width over 4 chunks.
SSD_CASES = [("hymba_prefill", 1, 24, 50, 64, 16, 64),
             ("long", 4, 4096, 50, 64, 16, 64),
             ("mamba2_prefill", 8, 24, 32, 64, 128, 64),
             ("mamba2_long", 1, 2048, 32, 64, 128, 64),
             ("ref_a", 1, 64, 2, 16, 8, 16),
             ("ref_b", 2, 128, 4, 32, 16, 32),
             ("ref_c", 1, 96, 1, 8, 4, 32),
             ("chunks_q24", 2, 96, 8, 32, 16, 24),
             ("chunks_q1", 2, 16, 4, 8, 4, 1),
             ("mamba2_chunks", 2, 256, 32, 64, 128, 64)]


def ssd_inputs(torch, F, gen, B, S, H, P, N, dtype):
    """x, b, c (in ``dtype``), la, dt (float32) on the card as the model
    feeds them: dt = softplus(normal), la a negative log decay."""
    dev = gen.device
    x = torch.randn(B, S, H, P, generator=gen, device=dev)
    b = torch.randn(B, S, N, generator=gen, device=dev)
    c = torch.randn(B, S, N, generator=gen, device=dev)
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    la = -torch.exp(0.3 * torch.randn(B, S, H, generator=gen, device=dev)) \
        * dt
    return [t.to(dtype).contiguous() for t in (x, b, c)] + [la, dt]


def ssd_phase(torch, F, gen):
    """ssd_scan against ssd_scan_plain on the card at every case, float32
    and bfloat16 inputs; times the kernel at hymba's and mamba2's prefill
    and the long cases."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
    results, max_err, timing = [], 0.0, {}
    for dtype in ("float32", "bfloat16"):
        for name, B, S, H, P, N, chunk in SSD_CASES:
            ins = ssd_inputs(torch, F, gen, B, S, H, P, N,
                             getattr(torch, dtype))
            y, st = ssd_mod.ssd_scan(*ins, chunk=chunk)
            torch.cuda.synchronize()
            py, pst = ssd_mod.ssd_scan_plain(*ins, chunk=chunk)
            ok_y, e_y = close(y, py, *SSD_TOL)
            ok_s, e_s = close(st, pst, *SSD_TOL)
            finite = bool(torch.isfinite(y).all() and
                          torch.isfinite(st).all())
            ok = ok_y and ok_s and finite and y.dtype == torch.float32
            print(f"[kernel] ssd_scan {name:13s} {dtype:8s} B={B} S={S} "
                  f"H={H} P={P} N={N} q={min(chunk, S)} y_err={e_y:.3e} "
                  f"state_err={e_s:.3e} tol(atol,rtol)={SSD_TOL} "
                  f"{'ok' if ok else 'MISMATCH'}")
            results.append(dict(case=name, dtype=dtype, y_err=e_y,
                                state_err=e_s, ok=ok))
            max_err = max(max_err, e_y, e_s)
            if name in ("hymba_prefill", "long", "mamba2_prefill",
                        "mamba2_long"):
                timing[f"{name}/{dtype}"] = time_ssd(torch, ssd_mod, ins,
                                                     chunk, dtype)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"ssd_scan disagrees with its plain twin: "
                             f"{bad}")
    return results, max_err, timing


def time_ssd(torch, ssd_mod, ins, chunk: int, dtype: str) -> dict:
    """Kernel and plain twin at one case; the bound from the bytes (every
    input read once in its dtype, y and the state written once in f32)
    and the
    operations of the chunked algorithm (C B^T on the lower triangle once
    per batch and chunk; per head W x, the carried state's term and the
    state update).  No single PyTorch call computes the scan, so there
    is no library time."""
    x, b = ins[0], ins[1]
    B, S, H, P = x.shape
    N = b.shape[-1]
    q = min(chunk, S)
    n_chunks = S // q
    bytes_moved = (sum(t.numel() * t.element_size() for t in ins)
                   + B * S * H * P * 4 + B * H * P * N * 4)
    tri = q * (q + 1) // 2
    ops_count = B * n_chunks * (2 * tri * N
                                + H * (2 * tri * P + 4 * q * P * N))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3

    def kern():
        ssd_mod.ssd_scan(*ins, chunk=chunk)

    def plain():
        ssd_mod.ssd_scan_plain(*ins, chunk=chunk)
    per_call = launches_of(kern, (ssd_mod.ssd_scan, "launches"),
                           (ssd_mod.ssd_scan, "pass_launches"))
    return dict(ms=counted_ms(kern, 20, "ssd_scan", "ssd_scan_", per_call),
                plain_ms=device_ms(plain, 5, "ssd_scan twin"),
                library_ms=None, event_ms=time_ms(kern, 20),
                plain_event_ms=time_ms(plain, 5),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, ops=ops_count)


def k5_inputs(torch, gen, B, Sq, Sk, H, D, dtype):
    dev = gen.device
    return [torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
            for S in (Sq, Sk, Sk)]


def k5_phase(torch, F, gen):
    """flash_attention against flash_attention_plain on the card at every
    case, float32 and bfloat16; times every case beside its bound, the
    plain twin and SDPA."""
    from repro_torch.kernels.flash_attention import flash_attention as k5
    results, timing, max_err = [], {}, 0.0
    sms = torch.cuda.get_device_properties(gen.device).multi_processor_count
    for dtype in ("float32", "bfloat16"):
        for name, B, Sq, Sk, H, D, causal in K5_CASES:
            q, k, v = k5_inputs(torch, gen, B, Sq, Sk, H, D,
                                getattr(torch, dtype))
            got = k5.flash_attention(q, k, v, causal=causal)
            o_lse, lse = k5.flash_attention_with_lse(q, k, v, causal=causal)
            torch.cuda.synchronize()
            bits = getattr(torch, _BITS[dtype])
            same_o = bool(torch.equal(o_lse.view(bits), got.view(bits)))
            want_lse = k5.flash_attention_plain(q, k, v, causal=causal,
                                                return_lse=True)[1]
            lse_err = float((lse - want_lse).abs().max())
            del o_lse, lse, want_lse
            want = k5.flash_attention_plain(q, k, v, causal=causal)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == "float32":
                atol, rtol = K5_TOL[dtype]
                tol = atol + rtol * want.abs()
                tol_txt = f"tol(atol,rtol)={K5_TOL[dtype]}"
            else:
                tol = k5_bf16_tol(k5, q, k, v, got, want, causal)
                tol_txt = f"tol per element {float(tol.min()):.2e}.." \
                          f"{float(tol.max()):.2e}"
            use = float((diff / tol).max())
            del diff, tol
            w = want.float()
            gain = float((got.float() * w).sum() / (w * w).sum())
            finite = bool(torch.isfinite(got.float()).all())
            ok = use <= 1.0 and abs(gain - 1.0) <= K5_GAIN_TOL and finite \
                and got.dtype == q.dtype and got.shape == q.shape \
                and same_o and lse_err <= K5_LSE_TOL
            plan = k5.split_plan(B, Sq, Sk, H, D, q.dtype, sms)
            print(f"[kernel] flash_attention {name:23s} {dtype:8s} B={B} "
                  f"Sq={Sq} Sk={Sk} H={H} D={D} causal={causal} "
                  f"kernel={plan.path} key ranges={plan.n_split} "
                  f"err={err:.3e} {tol_txt} (largest err/tol {use:.3f}) "
                  f"gain-1={gain - 1.0:+.2e} (tol {K5_GAIN_TOL:.2e}); with "
                  f"lse: o {'bitwise equal' if same_o else 'DIFFERENT'}, lse "
                  f"err {lse_err:.2e} (tol {K5_LSE_TOL:.0e}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            results.append(dict(case=name, dtype=dtype, err=err,
                                err_over_tol=use, gain=gain, ok=ok,
                                kernel=plan.path, key_ranges=plan.n_split,
                                lse_same_o=same_o, lse_err=lse_err))
            max_err = max(max_err, err)
            del got, want, w
            timing[f"{name}/{dtype}"] = time_k5(torch, F, k5, q, k, v,
                                                causal, dtype,
                                                f"{name}/{dtype}")
            del q, k, v
            torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"twin: {bad}")
    return results, max_err, timing


def k5_bf16_tol(k5, q, k, v, got, want, causal: bool):
    """The bound per element between K5 and its twin in bfloat16 (see
    ``K5_TOL``): 2 u (P|v|) + u (|got| + |want|) + Sk 2**-23 (P|v|), with
    P|v| the twin's softmax over |v| in float32."""
    u = 2.0 ** -8
    pv = k5.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                  causal=causal)
    return pv.mul_(2 * u + k.shape[1] * 2.0 ** -23) \
        .add_(got.float().abs().add_(want.float().abs()), alpha=u)


def k5_bound(q, k, causal: bool, dtype: str) -> dict:
    """K5's bound at one case: q, k, v read once and o written once over
    the memory rate, and the 4 D operations of each (query, key) pair the
    mask keeps (a causal mask keeps S (S + 1) / 2 of S^2) over the peak
    rate of the dtype; the larger."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
    ops_count = 4 * pairs * D
    bytes_moved = 2 * (q.numel() + k.numel()) * q.element_size()
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, ops=ops_count, pairs=pairs)


def time_k5(torch, F, k5, q, k, v, causal: bool, dtype: str,
            case: str = "") -> dict:
    """Kernel, plain twin and SDPA (on (B, H, S, D) copies made
    beforehand, the same mask, never called by the port) at one case,
    beside ``k5_bound``."""
    bound = k5_bound(q, k, causal, dtype)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    long = bound["pairs"] > 1 << 28

    def kern():
        k5.flash_attention(q, k, v, causal=causal)

    def plain():
        k5.flash_attention_plain(q, k, v, causal=causal)

    def lib():
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    return dict(ms=counted_ms(kern, 20, f"flash_attention {case}",
                              "flash_attn_", 1),
                plain_ms=device_ms(plain, 2 if long else 10,
                                   f"flash_attention twin {case}"),
                library_ms=device_ms(lib, 20, f"SDPA {case}"),
                event_ms=time_ms(kern, 20),
                plain_event_ms=time_ms(plain, 2 if long else 10),
                library_event_ms=time_ms(lib, 20), **bound)


# K2 tables: the embedding tables of the served configs, (V, D, dtypes):
# all in bf16, and those the dense float32 runs and starcoder2's float32
# run gather also in float32
GATHER_TABLES = {"hymba": (32001, 1600, ("bfloat16",)),
                 "qwen": (151936, 1024, ("bfloat16",)),
                 "arctic": (32000, 7168, ("bfloat16",)),
                 "whisper": (51865, 512, ("bfloat16", "float32")),
                 "mamba2": (50280, 1024, ("bfloat16", "float32")),
                 "starcoder2": (49152, 4608, ("bfloat16", "float32")),
                 "phi3": (100352, 5120, ("bfloat16",)),
                 "deepseek": (32256, 7168, ("bfloat16",)),
                 "kimi": (163840, 7168, ("bfloat16",)),
                 "paligemma": (257216, 2048, ("bfloat16", "float32"))}
# 8: a decode step's lanes; 24: one prompt; 192: a dense prefill of 8
# prompts of 24; 8192: a long prefill
GATHER_IDS = (8, 24, 192, 8192)
_BITS = {"bfloat16": "int16", "float32": "int32"}


def gather_phase(torch, F, gen):
    """gather_rows against table[ids] on the card, bitwise, on every
    table and dtype at each count of ``GATHER_IDS``, MARS-sorted as
    ``embedding_gather`` sorts them; times every case beside its bound,
    the plain twin and ``F.embedding``."""
    from repro_torch.kernels.mars_gather import mars_gather as mg_mod
    results, timing = [], {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=gen.device)
    for tname, (V, D, dtypes) in GATHER_TABLES.items():
        for dtype in dtypes:
            table = torch.randn(V, D, generator=gen, device=gen.device) \
                .to(getattr(torch, dtype))
            bits = getattr(torch, _BITS[dtype])
            for n in GATHER_IDS:
                for idx in (torch.int32, torch.int64):
                    ids = torch.randint(0, V, (n,), generator=gen,
                                        device=gen.device).to(idx)
                    sids = ids[torch.argsort(ids >> 2, stable=True)]
                    got = mg_mod.gather_rows(table, sids)
                    torch.cuda.synchronize()
                    want = mg_mod.gather_rows_plain(table, sids)
                    ok = bool(torch.equal(got.view(bits), want.view(bits)))
                    iname = str(idx).split(".")[-1]
                    print(f"[kernel] gather_rows {tname} table {V}x{D} "
                          f"{dtype}, {n} {iname} ids: "
                          f"{'bitwise equal' if ok else 'MISMATCH'}")
                    results.append(dict(table=tname, dtype=dtype, n=n,
                                        idx=iname, ok=ok))
                    if idx is torch.int32:
                        key = f"{tname}/{n}" if dtype == "bfloat16" \
                            else f"{tname}/{n}/{dtype}"
                        timing[key] = time_gather(torch, F, mg_mod, table,
                                                  sids, flush)
            del table
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"gather_rows disagrees with its plain twin: "
                             f"{bad}")
    return results, timing


def time_gather(torch, F, mg_mod, table, sids, flush) -> dict:
    """Kernel, plain twin and ``F.embedding`` on the same ids, each with
    a cold L2 (``cold_ms``: a serve step gathers rows the card has not
    read lately; repeated calls on the same ids would find them in L2)
    and, as ``warm_*``, repeated under the profiler; the bound is the
    rows read and written plus the ids over the memory rate (no
    arithmetic)."""
    n, D = sids.shape[0], table.shape[1]
    bytes_moved = 2 * n * D * table.element_size() \
        + n * sids.element_size()

    def kern():
        mg_mod.gather_rows(table, sids)

    def plain():
        mg_mod.gather_rows_plain(table, sids)

    def lib():
        F.embedding(sids, table)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return dict(ms=cold_ms(torch, kern, 30, flush),
                plain_ms=cold_ms(torch, plain, 30, flush),
                library_ms=cold_ms(torch, lib, 30, flush),
                warm_ms=device_ms(kern, 50, "gather_rows"),
                warm_plain_ms=device_ms(plain, 50, "gather_rows twin"),
                warm_library_ms=device_ms(lib, 50, "F.embedding"),
                event_ms=time_ms(kern, 50), plain_event_ms=time_ms(plain, 50),
                library_event_ms=time_ms(lib, 50), bound_ms=t_bytes,
                bound_by="bytes", bytes=bytes_moved, ops=0)


# K4 tolerance against its plain twin, (atol, rtol): both sum the same
# float32 products, in another order (up to 7168 a row); in bfloat16 both
# round that sum to bf16, so a value may land one bf16 spacing away
# (2**-7 relative)
K4_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# K4 cases: (name, dtype, spec).  "ref" specs are the reference's kernel
# tests (M, K, N, G, bm) with random group-sorted tiles; "route" specs
# route A assignments over E experts, sort and pad them as the serve path
# does (bm = the serve path's tile), for one (E, K, N) weight matrix:
# arctic-480b's decode (8 lanes x top-2) through w_in and w_out, its
# engine prefill (24 tokens x top-2), and kimi-k2's decode (8 lanes x
# top-8 over 384 experts, K 7168 -> N 2048).
K4_REF = [(256, 128, 128, 2, 128), (512, 256, 128, 4, 128),
          (256, 512, 256, 8, 64), (128, 128, 384, 3, 32)]
K4_ROUTE = [("arctic_decode_w_in", 8, 2, 128, 7168, 4864),
            ("arctic_decode_w_out", 8, 2, 128, 4864, 7168),
            ("arctic_prefill_w_in", 24, 2, 128, 7168, 4864),
            ("kimi_decode_w_in", 8, 8, 384, 7168, 2048)]
# K4 cases the TMA kernel's cuts can get wrong: (name, dtype, spec) with
# spec (M, K, N, G, bm, tile groups, n_tiles).  A K that no slab (nor a
# 32-row stage) divides and an N that no 512-column span (nor a 64-column
# box) divides; several consecutive tiles of one expert; n_tiles 0 and
# n_tiles = every tile; group ids outside [0, G) (-1 and G) among live
# tiles; a K and an N that are not multiples of 8 (bf16 through the
# CUDA-core kernel: TMA cannot map them).  Tiles at or past n_tiles and
# tiles of a bad group must come out exactly 0.
K4_EDGE = [("ragged_k_n", (64, 7000, 1000, 4, 16, (0, 1, 1, 3), 4)),
           ("one_expert_run", (128, 2048, 1536, 4, 16,
                                (2, 2, 2, 2, 2, 3, 3, 3), 8)),
           ("n_tiles_0", (64, 1024, 1024, 4, 16, (0, 1, 2, 3), 0)),
           ("bad_groups", (96, 1024, 1024, 4, 16, (0, -1, 1, 4, 2, 3), 6)),
           ("bm32_ragged", (128, 1000, 520, 3, 32, (0, 0, 2, 2), 3)),
           ("unaligned_k_n", (64, 100, 36, 2, 16, (0, 1, 1, 0), 4))]


def k4_ref_case(torch, gen, M, K, N, G, bm, dtype):
    """The reference test's operands: x, w / sqrt(K), sorted random tile
    groups; every tile in use, no padding rows."""
    dev = gen.device
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    w = (torch.randn(G, K, N, generator=gen, device=dev) / K ** 0.5) \
        .to(dtype)
    tg = torch.sort(torch.randint(0, G, (M // bm,), generator=gen,
                                  device=dev))[0].to(torch.int32)
    sizes = torch.bincount(tg, minlength=G) * bm
    return dict(x=x, w=w, tg=tg, bm=bm, n_used=None, real_rows=None,
                sizes=sizes, used_groups=int((sizes > 0).sum()), A=M)


def k4_route_case(torch, gen, T, k, E, K, N, dtype):
    """T tokens routed top-k over E experts (distinct per token), sorted
    and padded as ``models.moe`` does, on a (E, K, N) weight of scale
    1/sqrt(K).  The weight is drawn one expert at a time in ``dtype``."""
    from repro_torch.kernels.moe_dispatch import ops as k4_ops
    from repro_torch.models.moe import SERVE_BM
    dev = gen.device
    idx = torch.stack([torch.randperm(E, generator=gen, device=dev)[:k]
                       for _ in range(T)])
    flat = idx.reshape(-1)
    perm = torch.argsort(flat, stable=True)
    sorted_e = flat[perm]
    A = T * k
    rows = torch.randn(A, K, generator=gen, device=dev).to(dtype)
    slot, tg, M_pad, n_used = k4_ops.pad_sorted_groups(
        sorted_e, perm, E, SERVE_BM, tight=True)
    x = torch.zeros(M_pad, K, dtype=dtype, device=dev)
    x[slot.long()] = rows
    w = torch.empty(E, K, N, dtype=dtype, device=dev)
    for e in range(E):
        w[e] = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    sizes = torch.bincount(sorted_e, minlength=E)
    return dict(x=x, w=w, tg=tg, bm=SERVE_BM, n_used=n_used,
                real_rows=slot.long(), rows=rows, sizes=sizes,
                used_groups=int((sizes > 0).sum()), A=A)


def k4_edge_case(torch, gen, M, K, N, G, bm, groups, n_tiles, dtype):
    """Operands with a given tile -> group map and n_tiles: x drawn in
    full (padding rows are not zero here, so a dead tile's zeros are the
    kernel's own), w / sqrt(K)."""
    dev = gen.device
    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    w = (torch.randn(G, K, N, generator=gen, device=dev) / K ** 0.5) \
        .to(dtype)
    tg = torch.tensor(groups, dtype=torch.int32, device=dev)
    n_used = torch.tensor([n_tiles], dtype=torch.int32, device=dev)
    live = [i for i, g in enumerate(groups) if i < n_tiles and 0 <= g < G]
    dead = torch.ones(M, dtype=torch.bool, device=dev)
    for i in live:
        dead[i * bm:(i + 1) * bm] = False
    used = {groups[i] for i in live}
    sizes = torch.tensor([bm * sum(1 for i in live if groups[i] == g)
                          for g in range(G)], device=dev)
    return dict(x=x, w=w, tg=tg, bm=bm, n_used=n_used, real_rows=None,
                dead_rows=dead, sizes=sizes, used_groups=len(used),
                A=len(live) * bm)


def k4_library(torch, c):
    """One PyTorch call for the same products on the unpadded sorted
    rows: ``torch._grouped_mm`` (bf16, group ends as ``offs``) where this
    torch has it and takes the operands, else a loop of ``torch.matmul``
    over the used experts.  Returns (fn, which)."""
    x, w, sizes = c["x"], c["w"], c["sizes"]
    rows = c["rows"] if c["real_rows"] is not None else x
    ends = torch.cumsum(sizes, 0)
    offs = ends.to(torch.int32)
    if x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(rows, w, offs=offs)
            torch.cuda.synchronize()
            return (lambda: torch._grouped_mm(rows, w, offs=offs)), \
                "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError) as e:
            print(f"[kernel] grouped_matmul: torch._grouped_mm refused the "
                  f"operands ({str(e).splitlines()[0][:120]}); timing a "
                  f"torch.matmul loop instead")
    bounds = [0] + ends.tolist()
    segs = [(g, bounds[g], bounds[g + 1]) for g in range(w.shape[0])
            if bounds[g + 1] > bounds[g]]

    def loop():
        for g, a, b in segs:
            torch.matmul(rows[a:b], w[g])
    return loop, "torch.matmul loop over used experts"


def k4_phase(torch, gen):
    """grouped_matmul against grouped_matmul_plain on the card at every
    case; padding rows and unused tiles must come out exactly 0.  Times
    every case beside its bound, the plain twin and the library call."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as k4
    cases = [(f"ref_{M}x{K}x{N}_G{G}_bm{bm}", dtype,
              ("ref", (M, K, N, G, bm)))
             for dtype in ("float32", "bfloat16") for M, K, N, G, bm in K4_REF]
    cases += [(r[0], "bfloat16", ("route", r[1:])) for r in K4_ROUTE]
    cases += [(name, dtype, ("edge", spec)) for dtype in
              ("bfloat16", "float32") for name, spec in K4_EDGE]
    results, timing, max_err = [], {}, 0.0
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=gen.device)
    for name, dtype, (kind, spec) in cases:
        dt = getattr(torch, dtype)
        c = (k4_ref_case(torch, gen, *spec, dt) if kind == "ref"
             else k4_route_case(torch, gen, *spec, dt) if kind == "route"
             else k4_edge_case(torch, gen, *spec, dt))
        got = k4.grouped_matmul(c["x"], c["w"], c["tg"], bm=c["bm"],
                                n_tiles=c["n_used"])
        torch.cuda.synchronize()
        want = k4.grouped_matmul_plain(c["x"], c["w"], c["tg"], bm=c["bm"],
                                       n_tiles=c["n_used"])
        ok, err = close(got, want, *K4_TOL[dtype])
        zero_ok = True
        if c["real_rows"] is not None:
            pad = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
            pad[c["real_rows"]] = False
            zero_ok = bool((got[pad] == 0).all())
        if c.get("dead_rows") is not None:
            zero_ok = bool((got[c["dead_rows"]] == 0).all())
        finite = bool(torch.isfinite(got.float()).all())
        ok = ok and zero_ok and finite and got.dtype == dt
        M, K = c["x"].shape
        G, _, N = c["w"].shape
        print(f"[kernel] grouped_matmul {name:28s} {dtype:8s} M={M} K={K} "
              f"N={N} G={G} bm={c['bm']} assignments={c['A']} "
              f"experts used={c['used_groups']} err={err:.3e} "
              f"tol(atol,rtol)={K4_TOL[dtype]} padding rows zero={zero_ok} "
              f"{'ok' if ok else 'MISMATCH'}")
        results.append(dict(case=name, dtype=dtype, err=err, ok=ok))
        max_err = max(max_err, err)
        if kind != "edge":
            timing[f"{name}/{dtype}"] = time_k4(torch, k4, c, dtype, flush)
        del c, got, want
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"grouped_matmul disagrees with its plain "
                             f"twin: {bad}")
    return results, max_err, timing


def time_k4(torch, k4, c, dtype: str, flush) -> dict:
    """Kernel, plain twin and library call at one case, each with a cold
    L2 (``cold_ms``: a serve step reads expert weights no recent call
    left in L2; repeated calls on the same weights would find up to 50 MB
    of them there) and, as ``warm_*``, repeated under the profiler.
    Bound: the bytes this case needs — x read once, the used experts'
    weights read once, the (M, N) output written once, the tile map — and
    the operations of the real rows (2 A K N); the larger over the H100's
    rates."""
    x, w, tg, bm, n_used = c["x"], c["w"], c["tg"], c["bm"], c["n_used"]
    M, K = x.shape
    N = w.shape[2]
    eb = x.element_size()
    bytes_moved = (x.numel() * eb + c["used_groups"] * K * N * eb
                   + M * N * eb + tg.numel() * 4)
    ops_count = 2 * c["A"] * K * N
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3
    lib, which = k4_library(torch, c)

    def kern():
        k4.grouped_matmul(x, w, tg, bm=bm, n_tiles=n_used)

    def plain():
        k4.grouped_matmul_plain(x, w, tg, bm=bm, n_tiles=n_used)
    return dict(ms=cold_ms(torch, kern, 10, flush),
                plain_ms=cold_ms(torch, plain, 3, flush),
                library_ms=cold_ms(torch, lib, 10, flush), library=which,
                warm_ms=device_ms(kern, 10, "grouped_matmul"),
                warm_plain_ms=device_ms(plain, 3, "grouped_matmul twin"),
                warm_library_ms=device_ms(lib, 10, which),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, ops=ops_count)


# The paper simulator's two device scans (S1, the MARS cycle engine; S2,
# the FR-FCFS DRAM channels).  Both are integer programs: the kernels must
# equal their plain twins (and S1 the OrderedDict oracle) exactly.
SIM_RPC = 256                      # paper_figures.RPC: n = 16384 a workload
SIM_GRID_RPC = 128                 # ablations.RPC
SIM_WINDOWS = (8, 32, 64)
# the reference's means at SIM_RPC (JAX package on the CPU): Fig 7, Fig 8
SIM_FIG_MEANS = (0.2931131004369563, 1.0771324453693047)
# the new rows of the kernels line: (name, source, replaces)
SIM_KERNELS = (("mars_engine", "mars_engine.cu", "src/repro/core/mars.py:247"),
               ("dram_channel", "dram_channel.cu",
                "src/repro/core/dram.py:219"))


def sim_streams(name: str, rpc: int):
    """(addr, ports, src, is_write) of one of the paper's workloads."""
    import numpy as np
    from repro_torch.core import streams
    gpu = streams.GpuConfig()
    wl = streams.make_workload(name, gpu, reqs_per_core=rpc)
    src = np.asarray(wl.source)
    return (np.asarray(wl.addr), src // gpu.cores_per_group, src,
            np.asarray(wl.is_write))


def sim_random_streams():
    """Seeded random streams: (name, addr, ports, src, MarsConfig).  One
    page (every request hits one entry), few pages (sets fill, ports
    stall on full sets), many pages (misses everywhere, ways 4, 4 ports
    over 32 cores at an MSHR cap of 4), a PhyPageList of 3 ways (sets
    not a power of two) and a RequestQ of 1024 (every free word)."""
    import numpy as np
    from repro_torch.core import mars
    rng = np.random.default_rng(0)
    out = []
    for name, n_pages, n, cfg in (
            ("one_page", 1, 4096, mars.MarsConfig()),
            ("few_pages", 6, 4096, mars.MarsConfig(request_q=64,
                                                   page_entries=8)),
            ("many_pages", 5000, 8192, mars.MarsConfig(
                ways=4, n_ports=4, mshr_per_core=4)),
            ("ways3", 300, 8192, mars.MarsConfig(page_entries=96, ways=3)),
            ("request_q_1024", 2000, 8192, mars.MarsConfig(
                request_q=1024, page_entries=256, mshr_per_core=64))):
        pages = rng.integers(0, n_pages, n)
        addr = (pages * 64 + rng.integers(0, 64, n)).astype(np.int32)
        src = rng.integers(0, 32, n).astype(np.int32)
        out.append((name, addr, src % cfg.n_ports, src, cfg))
    return out


def sim_plain_mars(addr, ports, src, cfg):
    """S1's plain twin on the host: (perm, stall events, total cycles,
    host ms)."""
    import numpy as np
    from repro_torch.core import mars
    from repro_torch.kernels.mars_engine.ref import mars_engine_plain
    t0 = time.perf_counter()
    pages, port_req, port_len, src_, n_cores = mars.prepare(addr, ports, cfg,
                                                            src)
    emits, stalls = mars_engine_plain(pages, port_req, port_len, src_,
                                      len(addr), n_cores, cfg)
    ms = (time.perf_counter() - t0) * 1e3
    cycles = np.flatnonzero(emits >= 0)
    return (emits[cycles].astype(np.int64), stalls,
            int(cycles[-1]) + 1 if len(cycles) else 0, ms)


def sim_channel_operands(torch, addr, is_write, cfg, device="cuda"):
    """``dram_channels``' operands for a stream on ``device``, as
    ``simulate`` builds them."""
    from repro_torch.core import dram
    return tuple(torch.from_numpy(a).to(device)
                 for a in dram.channel_operands(addr, cfg, is_write))


def sim_plain_channels(ops, cfg):
    """S2's plain twin on host copies of the operands: ((t_end, n_act,
    hits) a channel, host ms)."""
    from repro_torch.kernels.dram_channel.ref import run_channel_plain
    local, wr, off = (t.cpu() for t in ops)
    t0 = time.perf_counter()
    b = off.tolist()
    rows = [run_channel_plain(local[i:j].tolist(), wr[i:j].tolist(), cfg)
            for i, j in zip(b, b[1:])]
    return rows, (time.perf_counter() - t0) * 1e3


def sim_bytes_mars(addr, ports, src, cfg) -> int:
    """Bytes S1 must move: pages, src and the port queues read once, the
    permutation (int64) and 3 stats written once."""
    from repro_torch.core import mars
    _, port_req, port_len, _, _ = mars.prepare(addr, ports, cfg, src)
    n = len(addr)
    return 4 * n + 4 * n + 4 * port_req.size + 4 * port_len.size + 8 * n + 12


def sim_bytes_channels(ops) -> int:
    """Bytes S2 must move: line ids (int32), write flags (uint8) and
    offsets read once, 3 int32 a channel written once."""
    local, wr, off = ops
    return 4 * local.numel() + wr.numel() + 8 * off.numel() \
        + 12 * (off.numel() - 1)


SIM_PATH = "experiment.run_all --device cuda"


def sim_kernel_rows(launches: dict, timing: dict) -> list:
    """The ``{"kernels": [...]}`` rows of S1 and S2: launches on the main
    path (``SIM_PATH`` in ``launches``), exact against their twins, timed
    at WL1 (``sim_phase``).  ``plain_ms`` is the twin's host time: it is a
    host loop.  No PyTorch call computes either scan."""
    rows = []
    for name, source, replaces in SIM_KERNELS:
        t = timing[name]
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
            replaces=replaces, launches=launches[SIM_PATH][name],
            launches_by_path={p: n[name] for p, n in launches.items()},
            max_abs_err=0, ms=t["ms"], plain_ms=t["plain_ms"],
            plain_on="host", bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None, serial_steps=t["serial_steps"],
            ns_per_step=t["ns_per_step"]))
    return rows


def sim_baseline_check(rows, path=None) -> list:
    """The port's ``benchmarks/run.py`` comparison of simulated rows with
    ``results/bench_baseline.json`` (exact at the printed precision)."""
    from repro_torch.benchmarks import run as bench_run
    with open(path or ROOT / "results" / "bench_baseline.json") as f:
        baseline = json.load(f)
    return bench_run.check_baseline(rows, baseline)


def sim_phase(torch):
    """S1 and S2 against their plain twins, S1 against the oracle, the
    smoke rows against the repo's baseline, then the main path
    (``experiment.run_all`` at RPC 256 on the card) with its launches
    counted, Fig 7 / Fig 8 printed, and each kernel timed.  Returns
    (record, timing, launches of the main path)."""
    import numpy as np
    from repro_torch.benchmarks import ablations, kvcache_sim
    from repro_torch.core import dram, experiment, mars, streams
    from repro_torch.kernels.dram_channel import dram_channel as dc_mod
    from repro_torch.kernels.mars_engine import mars_engine as me_mod
    record, timing, bad = {"mars": {}, "dram": {}}, {}, []

    def held(kind, case, ok, **info):
        record[kind][case] = dict(ok=bool(ok), **info)
        if not ok:
            bad.append(f"{kind} {case}: {info}")

    # S1 against its twin: WL1-WL5 at RPC 256, then the random streams
    cfg0 = mars.MarsConfig()
    cases = [(wl,) + sim_streams(wl, SIM_RPC)[:3] + (cfg0,)
             for wl in streams.WORKLOADS] + sim_random_streams()
    for case, addr, ports, src, cfg in cases:
        perm, st = mars.mars_reorder(addr, ports, cfg, src=src)
        want, stalls, total, host_ms = sim_plain_mars(addr, ports, src, cfg)
        info = dict(n=len(addr), stall_events=st["stall_events"],
                    total_cycles=st["total_cycles"], twin_stalls=stalls,
                    twin_cycles=total, twin_host_ms=host_ms)
        ok = (np.array_equal(perm, want) and st["stall_events"] == stalls
              and st["total_cycles"] == total)
        if not case.startswith("WL"):
            ok = ok and np.array_equal(perm, mars.mars_reorder_reference(
                addr, ports, cfg, src))
        held("mars", case, ok, **info)
        print(f"[sim] mars_engine {case}: n {len(addr)}, perm "
              f"{'equal' if ok else 'DIFFERENT'} to the plain twin"
              f"{'' if case.startswith('WL') else ' and the oracle'}; "
              f"stall events {st['stall_events']} (twin {stalls}), total "
              f"cycles {st['total_cycles']} (twin {total}); twin host "
              f"{host_ms:.0f} ms")
    # S1 against the oracle on the ablation grid at RPC 128
    grid_ok = 0
    for name, v, cfg in ablations.configs():
        for wl in streams.WORKLOADS:
            addr, ports, src, _ = sim_streams(wl, SIM_GRID_RPC)
            perm, st = mars.mars_reorder(addr, ports, cfg, src=src)
            ok = np.array_equal(perm, mars.mars_reorder_reference(
                addr, ports, cfg, src))
            grid_ok += ok
            if not ok:
                held("mars", f"grid {name}={v} {wl}", ok,
                     stall_events=st["stall_events"])
    n_grid = len(ablations.configs()) * len(streams.WORKLOADS)
    record["mars"]["grid"] = dict(ok=grid_ok == n_grid, equal=grid_ok,
                                  of=n_grid)
    print(f"[sim] mars_engine ablation grid at RPC {SIM_GRID_RPC}: "
          f"{grid_ok} of {n_grid} permutations equal to the oracle")
    # S2 against its twin: baseline and MARS-ordered streams, 3 windows
    for wl in streams.WORKLOADS:
        addr, ports, src, wr = sim_streams(wl, SIM_RPC)
        perm, _ = mars.mars_reorder(addr, ports, cfg0, src=src)
        for order, a, w in (("base", addr, wr),
                            ("mars", addr[perm], wr[perm])):
            for window in SIM_WINDOWS:
                cfg = dram.DramConfig(window=window)
                ops = sim_channel_operands(torch, a, w, cfg)
                got = dc_mod.dram_channels(*ops, cfg).cpu().tolist()
                want, host_ms = sim_plain_channels(ops, cfg)
                held("dram", f"{wl}/{order}/w{window}",
                     [tuple(r) for r in got] == want, got=got, want=want,
                     twin_host_ms=host_ms)
    # short streams: n below the window, one channel empty, n = 0
    rng = np.random.default_rng(1)
    for n, window in ((5, 8), (20, 32), (40, 64), (3, 64)):
        cfg = dram.DramConfig(window=window)
        a = rng.integers(0, 1 << 20, n).astype(np.int32)
        w = rng.random(n) < 0.3
        ops = sim_channel_operands(torch, a, w, cfg)
        got = dc_mod.dram_channels(*ops, cfg).cpu().tolist()
        held("dram", f"short{n}/w{window}",
             [tuple(r) for r in got] == sim_plain_channels(ops, cfg)[0],
             got=got)
    one = (np.arange(64, dtype=np.int32) // 2) * 4   # channel 0 alone
    r = dram.simulate(one)
    held("dram", "one_channel", r.per_channel_cycles[1] == 0 and
         r == dram.simulate(one, device="cpu"), cycles=r.cycles)
    r = dram.simulate(np.zeros(0, np.int32))
    held("dram", "empty", r.cycles == 0 and r.n_act == 1
         and r.achieved_gbps == 0.0, cycles=r.cycles)
    n_dram = len(record["dram"])
    n_eq = sum(v["ok"] for v in record["dram"].values())
    print(f"[sim] dram_channel: {n_eq} of {n_dram} cases (5 workloads x "
          f"baseline/MARS order x windows {SIM_WINDOWS}, short streams, one "
          f"channel, n = 0) equal to the plain twin")

    # the smoke rows of benchmarks/run.py on the card against the baseline
    rows = []
    kvcache_sim.run(lambda name, us, derived="": rows.append(
        dict(name=name, us_per_call=us, derived=derived)), smoke=True,
        device="cuda")
    diff = sim_baseline_check(rows)
    record["baseline"] = dict(rows=len(rows), differences=diff)
    bad += [f"baseline {d}" for d in diff]
    print(f"[sim] benchmarks/run.py --smoke rows on the card: {len(rows)} "
          f"rows, {len(diff)} differences from results/bench_baseline.json"
          + "".join(f"\n[sim]   {d}" for d in diff))

    # the main path: Fig 7 / Fig 8 at RPC 256, launches counted
    counters = kernel_counters()
    reset_counts(counters)
    t0 = time.perf_counter()
    results = experiment.run_all(reqs_per_core=SIM_RPC, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    n_wl = len(streams.WORKLOADS)
    want = {k: 0 for k in counters}
    want.update(mars_engine=n_wl, dram_channel=2 * n_wl)
    summary = experiment.summarize(results)
    for r in results:
        print(f"[sim] {r.name}: baseline {r.baseline.cycles} cycles, "
              f"{r.baseline.n_act} ACTs; MARS {r.with_mars.cycles} cycles, "
              f"{r.with_mars.n_act} ACTs; Fig 7 bandwidth uplift "
              f"{100 * r.bw_uplift:.2f}%, Fig 8 CAS/ACT uplift "
              f"{100 * r.cas_act_uplift:.2f}%")
    means = (summary["mean_bw_uplift"], summary["mean_cas_act_uplift"])
    print(f"[sim] mean over WL1-WL5 at RPC {SIM_RPC}: Fig 7 "
          f"{100 * means[0]:.2f}%, Fig 8 {100 * means[1]:.2f}% (reference "
          f"{100 * SIM_FIG_MEANS[0]:.2f}% / {100 * SIM_FIG_MEANS[1]:.2f}%); "
          f"run_all wall {wall:.2f}s; launches "
          + ", ".join(f"{k} {launches[k]}" for k, _, _ in SIM_KERNELS))
    record["figures"] = dict(summary, wall_s=wall, workloads={
        r.name: dict(baseline_cycles=r.baseline.cycles,
                     baseline_acts=r.baseline.n_act,
                     mars_cycles=r.with_mars.cycles,
                     mars_acts=r.with_mars.n_act) for r in results})
    if means != SIM_FIG_MEANS:
        bad.append(f"Fig 7 / Fig 8 means {means}, reference {SIM_FIG_MEANS}")
    if launches != want:
        bad.append(f"main path launches {launches}, want {want}")

    # each kernel per call at the main path's shapes (WL1, RPC 256)
    addr, ports, src, wr = sim_streams("WL1", SIM_RPC)
    pages, port_req, port_len, src_, n_cores = mars.prepare(addr, ports,
                                                            cfg0, src)
    dev_in = [torch.from_numpy(a).cuda()
              for a in (pages, port_req, port_len, src_)]
    total = record["mars"]["WL1"]["total_cycles"]
    steps = total * (cfg0.n_ports + 1)
    rows_ = device_profile(lambda: me_mod.mars_engine(*dev_in, n_cores, cfg0),
                           3, "mars_engine WL1", need=("mars_engine_kernel",))
    ms = rows_ms(rows_, "mars_engine_kernel")
    t_bytes = sim_bytes_mars(addr, ports, src, cfg0) / HBM_BYTES_PER_S * 1e3
    timing["mars_engine"] = dict(
        ms=ms, plain_ms=sim_plain_mars(addr, ports, src, cfg0)[3],
        bound_ms=t_bytes, bound_by="bytes", library_ms=None,
        cycles=total, serial_steps=steps, us_per_cycle=1e3 * ms / total,
        ns_per_step=1e6 * ms / steps)
    cfg = dram.DramConfig()
    ops = sim_channel_operands(torch, addr, wr, cfg)
    rows_ = device_profile(lambda: dc_mod.dram_channels(*ops, cfg), 5,
                           "dram_channel WL1", need=("dram_channel_kernel",))
    ms = rows_ms(rows_, "dram_channel_kernel")
    steps = int(max(np.diff(ops[2].cpu().numpy())))   # the longer channel
    timing["dram_channel"] = dict(
        ms=ms, plain_ms=sim_plain_channels(ops, cfg)[1],
        bound_ms=sim_bytes_channels(ops) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, cycles=steps, serial_steps=steps,
        us_per_cycle=1e3 * ms / steps, ns_per_step=1e6 * ms / steps)
    for name, t in timing.items():
        print(f"[kernel] {name} WL1 at RPC {SIM_RPC}: device ms per call "
              f"{t['ms']:.3f}, bound {t['bound_ms']:.6f} (bytes; the serial "
              f"chain binds: {t['serial_steps']} dependent steps, "
              f"{t['ns_per_step']:.1f} ns each), {t['cycles']} simulated "
              f"{'cycles' if name == 'mars_engine' else 'requests'} "
              f"({t['us_per_cycle']:.4f} us each); plain twin on the host "
              f"{t['plain_ms']:.0f} ms; no PyTorch call computes the scan")
    if bad:
        raise AssertionError("sim phase: " + "; ".join(bad))
    return record, timing, launches


def flag_value(flags, flag: str, default):
    """The value a flag takes in ``serve_args(arch, flags)`` (the last
    occurrence wins, as in argparse)."""
    args = serve_args("", flags)
    if flag not in args:
        return default
    last = max(i for i, a in enumerate(args) if a == flag)
    return type(default)(args[last + 1])


class Promotions:
    """Records the destination blocks of every ``flush_promotions`` call
    of every ``TierManager`` while in use (a ``with`` block)."""

    def __enter__(self):
        from repro_torch.kvcache import tiers
        self.cls, self.orig = tiers.TierManager, \
            tiers.TierManager.flush_promotions
        self.dsts: dict = {}
        orig, dsts = self.orig, self.dsts

        def recording(tm):
            out = orig(tm)
            dsts.setdefault(id(tm), []).extend(out)
            return out
        self.cls.flush_promotions = recording
        return self

    def __exit__(self, *exc):
        self.cls.flush_promotions = self.orig


def mirror_check(torch, backend, promotions: Promotions) -> dict:
    """For every block that was promoted from a spill tier and still holds
    that prefix, after one more staging of its backend's mirror: the
    block's K and V pages in the staged device mirror, and in the host
    pool, equal the tier entry's payload bit for bit (byte views,
    ``torch.equal``).  Fails when no promoted block is left to check."""
    inner = getattr(backend, "backends", None) or [backend]
    checked = bad = 0
    for b in inner:
        if b.tiers is None:
            continue
        k_dev, v_dev = b._staged_pages()
        for dst in sorted(set(promotions.dsts.get(id(b.tiers), []))):
            key = b.prefix._by_bid.get(dst)
            entry = next((t._entries[key] for t in b.tiers.tiers
                          if key is not None and t.holds(key)), None)
            if entry is None:
                continue          # evicted (or dropped) since
            for dev, host, want in ((k_dev, b.pool.k_pages, entry.k),
                                    (v_dev, b.pool.v_pages, entry.v)):
                w = want.contiguous().view(torch.uint8)
                ok = torch.equal(dev[:, dst].cpu().contiguous()
                                 .view(torch.uint8), w) and torch.equal(
                    host[:, dst].contiguous().view(torch.uint8), w)
                bad += not ok
            checked += 1
    if bad or not checked:
        raise AssertionError(f"tier mirror check: {checked} promoted blocks "
                             f"resident, {bad} K/V planes differ from their "
                             f"tier payload")
    return dict(blocks=checked, dtype=str(inner[0].pool.k_pages.dtype))


def dispatch_order_check(torch, out) -> dict:
    """The sharded decode's dispatch-all-before-sync-any on one stream, at
    the run's width: two lanes a shard on the run's backend, two warm
    rounds, then one round under ``torch.profiler`` with each shard's
    dispatch and sync marked.  Holds that no shard's dispatch blocks the
    host (no synchronizing CUDA call inside any dispatch), that each
    shard's dispatch launched K1 once a layer, and that the last shard's
    K1 launches were issued on the host before shard 0's logits came
    back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.paged_attention import paged_attention as pa
    backend, params, cfg = out["backend"], out["params"], out["cfg"]
    n = len(backend.backends)
    prompts = list(out["prompts"].values())[:2 * n]
    sids = [backend.new_seq(params, list(p), shard=i % n)[0]
            for i, p in enumerate(prompts)]
    toks = [1] * len(sids)
    for _ in range(2):
        backend.decode(params, sids, toks)
    marks: list = []                  # (event, shard, K1 launches, time)

    def marked(i, what, fn):
        def call(*a, **kw):
            with record_function(f"shard{i}.{what}"):
                r = fn(*a, **kw)
            marks.append((what, i, pa.paged_attention.launches,
                          time.perf_counter()))
            return r
        return call
    for i, b in enumerate(backend.backends):
        b.dispatch_decode = marked(i, "dispatch", b.dispatch_decode)
        b.sync = marked(i, "sync", b.sync)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    backend.flush()
    torch.cuda.synchronize()
    k1_0 = pa.paged_attention.launches
    t0 = time.perf_counter()
    with prof:
        step = backend.dispatch_decode(params, toks, sids=sids)
        backend.sync(step)
        torch.cuda.synchronize()
    for b in backend.backends:
        del b.dispatch_decode, b.sync
    backend.flush()
    windows, calls = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name().startswith("shard") and "." in e.name():
            windows[e.name()] = (e.start_ns(), e.end_ns())
        elif e.name().startswith("cuda"):
            calls.append((e.start_ns(), e.name()))
    inside = {}
    for i in range(n):
        lo, hi = windows[f"shard{i}.dispatch"]
        for t, name in calls:
            if lo <= t <= hi:
                inside[name] = inside.get(name, 0) + 1
    blocking = {k: v for k, v in inside.items() if "Synchronize" in k
                or k in ("cudaMemcpy", "cudaFreeHost", "cudaFree")}
    disp = [m for m in marks if m[0] == "dispatch"]
    k1 = [b[2] - a for a, b in zip([k1_0] + [m[2] for m in disp], disp)]
    sync0 = next(m for m in marks if m[0] == "sync" and m[1] == 0)
    res = dict(shards=n, lanes=len(sids), calls_in_dispatch=inside,
               blocking=blocking, k1_per_dispatch=k1,
               dispatch_ms=[(m[3] - t0) * 1e3 for m in disp],
               shard0_logits_ms=(sync0[3] - t0) * 1e3,
               last_dispatch_before_logits=disp[-1][3] < sync0[3])
    print(f"[serve {out['cfg'].name} dispatch] {n} shards x 2 lanes, one "
          f"profiled round: dispatches end at "
          + ", ".join(f"{t:.2f}" for t in res["dispatch_ms"])
          + f" ms, shard 0's logits back at {res['shard0_logits_ms']:.2f} "
          f"ms; K1 launches per dispatch {k1}; CUDA calls inside the "
          f"dispatches: {inside}; blocking: {blocking or 'none'}")
    for sid in sids:
        backend.free_seq(sid)
    if blocking or not res["last_dispatch_before_logits"] or \
            any(c != cfg.n_layers for c in k1):
        raise AssertionError(f"sharded dispatch blocked the host or ran out "
                             f"of order: {res}")
    return res


# the engine's phase histograms (host clock): a pipelined decode round is
# flush (commit) -> dispatch -> sync inside one engine step
PHASES_MS = ("engine.step_ms", "engine.dispatch_ms", "engine.sync_ms",
             "engine.commit_ms")
# one request's timeline, in order, as the reference's validator wants it
LIFECYCLE = ("sched.offer", "engine.admit", "engine.prefill",
             "engine.token", "engine.free")


def metrics_check(out, name: str, flags) -> dict:
    """A ``--metrics`` run's ``metrics.json`` and ``trace.jsonl``, read
    with the port's own code: the trace replayed through
    ``analysis.races`` with ``require_pipeline`` (no violation, tokens
    sampled inside the write-back lag); gauges in range (the modelled
    row-hit %, occupancies, the prefix hit rate); decode tokens counted
    (the run's own); the step and the three phase histograms counted
    work with p50 <= p99; one request's offer -> admit -> prefill ->
    token -> free in order.  A tiered run must promote only what it
    demoted earlier on the same shard and decode after a promotion; a
    class run must pause at least once, alternate each request's pause
    and resume, and keep every ``sched.batch`` within its quotas.
    Prints one line; raises AssertionError on the first failure."""
    from repro_torch.analysis import races
    path = Path(flag_value(flags, "--metrics-path", "metrics_out"))
    snap = json.loads((path / "metrics.json").read_text())
    lines = (path / "trace.jsonl").read_text().splitlines()
    evs = [json.loads(line) for line in lines]
    g, c, h = snap["gauges"], snap["counters"], snap["histograms"]
    bad = []
    report = races.analyze_trace(lines, require_pipeline=True)
    bad += [f"races: {v}" for v in report.violations]
    in_range = [("dram.row_hit_pct", 100.0),
                ("kvcache.prefix_hit_rate", 1.0),
                ("tier.promote_row_hit_pct", 100.0)] + [
        (k, 1.0) for k in g if k.endswith(".occupancy")]
    bad += [f"gauge {k} = {g.get(k)}" for k, hi in in_range
            if k in g and not 0.0 <= g[k] <= hi]
    if "dram.row_hit_pct" not in g:
        bad.append("no dram.row_hit_pct gauge")
    bad += [f"counter {k} = {v}" for k, v in c.items() if v < 0]
    if not 0 < c.get("engine.decode_tokens", 0) == out["decode_tokens"]:
        bad.append(f"engine.decode_tokens {c.get('engine.decode_tokens')}, "
                   f"the run's {out['decode_tokens']}")
    for k in PHASES_MS:
        if not (k in h and h[k]["count"] > 0
                and h[k]["p50"] <= h[k]["p99"]):
            bad.append(f"histogram {k}: {h.get(k)}")
    first: dict = {}                  # (rid, event) -> first ts
    for e in evs:
        if "rid" in e:
            first.setdefault((e["rid"], e["ev"]), e["ts"])

    def in_order(rid) -> bool:
        ts = [first.get((rid, k)) for k in LIFECYCLE]
        return None not in ts and ts == sorted(ts)
    if not any(in_order(rid) for rid in out["finished"]):
        bad.append("no request's " + " -> ".join(LIFECYCLE) + " in order")
    if "--tiered-kv" in flags:
        demoted: dict = {}            # (shard, key) -> first demote ts
        promotes = [e for e in evs if e["ev"] == "tier.promote"]
        for e in evs:
            key = (e.get("shard"), e.get("key"))
            if e["ev"] == "tier.demote":
                demoted.setdefault(key, e["ts"])
            elif e["ev"] == "tier.promote" and (
                    key not in demoted or demoted[key] > e["ts"]):
                bad.append(f"tier.promote of {key} not demoted before")
        if not promotes or not any(
                e["ev"] == "backend.decode" and e["ts"] >= promotes[0]["ts"]
                for e in evs):
            bad.append("no tier.promote followed by a backend.decode")
    if "--classes" in flags:
        paused, pauses = set(), 0
        for e in evs:
            if e["ev"] == "sched.batch":
                bad += [f"sched.batch: class {k} {n} over quota "
                        f"{e['quotas'][k]}"
                        for k, n in e["classes"].items()
                        if e["quotas"].get(k, 0) and n > e["quotas"][k]]
            elif e["ev"] == "engine.pause":
                pauses += 1
                if e["rid"] in paused:
                    bad.append(f"rid {e['rid']} paused twice")
                paused.add(e["rid"])
            elif e["ev"] == "engine.resume":
                if e["rid"] not in paused:
                    bad.append(f"rid {e['rid']} resumed, not paused")
                paused.discard(e["rid"])
        if not pauses:
            bad.append("no engine.pause")
    if bad:
        raise AssertionError(f"{name}: telemetry check failed: {bad[:10]}")
    q, rest, line = host_phases(snap)
    res = dict(phases_ms=q, rest_of_step_mean_ms=rest,
               trace=snap["trace"], kept=len(evs),
               row_hit_pct_modelled=g["dram.row_hit_pct"],
               races=report.stats,
               tokens_per_s=out["decode_tokens"] / out["wall_s"])
    print(f"[metrics {name}] {line}; trace "
          f"events kept {len(evs)}, dropped {snap['trace']['dropped']}; "
        f"dram.row_hit_pct {res['row_hit_pct_modelled']:.2f} (modelled: the "
        f"reference's grid order on the paper's LPDDR4 map, not HBM3); "
        f"races {report.stats['dispatched']} dispatches, "
        f"{len(report.violations)} violations, lag_tokens "
        f"{report.stats['lag_tokens']}; tokens/s {res['tokens_per_s']:.1f}")
    return res


def host_phases(snap: dict) -> tuple:
    """The step and its three decode-round phases from a snapshot's
    histograms (host ms: p50 and p99 interpolated in the histogram's
    buckets, the mean exact), and the mean of the rest of a step
    (admission, prefills, sampling: the step's sum less the phases').
    Returns (phases, rest, a printable summary)."""
    h = snap["histograms"]
    q = {k.split(".")[1][:-3]: h[k] for k in PHASES_MS}
    rest = (q["step"]["sum"] - sum(q[k]["sum"] for k in
                                   ("dispatch", "sync", "commit"))) \
        / q["step"]["count"]
    line = "host ms p50/p99 (mean): " + ", ".join(
        f"{k} {v['p50']:.3f}/{v['p99']:.3f} ({v['mean']:.3f}, n={v['count']})"
        for k, v in q.items()) + f", rest of step (mean) {rest:.3f}"
    return q, rest, line


OVERHEAD_RUN = "qwen1_5_0_5b --metrics overhead"
OVERHEAD_ORDER = ("plain", "metrics", "metrics", "plain")


def metrics_overhead(torch, serve) -> dict:
    """Tokens/s of the plain qwen1.5-0.5b run without and with
    ``--metrics``, warm, in turns (``OVERHEAD_ORDER``), each its engine's
    wall on the host clock ending in a synchronize; no teacher-forced
    check.  Reported, not gated: host clocks spread between runs."""
    args = serve_args("qwen1_5_0_5b", ("--parity-checks", "0"))
    tps: dict = {"plain": [], "metrics": []}
    order = OVERHEAD_ORDER
    for kind in order:
        flags = metrics_flags("plain", f"{METRICS_DIR}/overhead") \
            if kind == "metrics" else ()
        out = serve.main(args + list(flags))
        tps[kind].append(out["decode_tokens"] / out["wall_s"])
        if out["obs"] is not None:
            print(f"[metrics overhead] warm --metrics run: "
                  + host_phases(out["obs"].snapshot())[2])
        del out
        free_device(torch, f"overhead run ({kind})")
    mean = {k: statistics.mean(v) for k, v in tps.items()}
    res = dict(order=order, tokens_per_s=tps,
               overhead=1.0 - mean["metrics"] / mean["plain"])
    print(f"[metrics overhead] qwen1_5_0_5b tokens/s, in turns "
          f"{'/'.join(order)}: plain {tps['plain']}, --metrics "
          f"{tps['metrics']}; overhead {100 * res['overhead']:.1f} % of "
          f"the plain mean (host clock; reported, not gated)")
    return res


TIER_FP8 = "qwen1_5_0_5b --tiered-kv float8_e4m3fn"


def tier_fp8_check(torch, serve) -> dict:
    """The tiered qwen1.5-0.5b run (``TIERED``) with its KV pool in
    float8_e4m3fn, whose dirty blocks cross to the mirror as bytes: it
    must demote and promote, pass ``mirror_check``, and launch K1's split
    and merge passes once a layer a decode step.  No teacher-forced check
    (``--parity-checks 0``): how far an fp8 cache moves the tokens is
    ``kv_fp8_check``'s question."""
    import dataclasses
    config = serve._config
    serve._config = lambda a: dataclasses.replace(config(a),
                                                  kv_dtype="float8_e4m3fn")
    counters = kernel_counters()
    reset_counts(counters)
    try:
        with Promotions() as promoted:
            out = serve.main(serve_args("qwen1_5_0_5b", TIERED + (
                "--parity-checks", "0")))
    finally:
        serve._config = config
    launches = read_counts(counters)
    k1 = out["cfg"].n_layers * out["decode_steps"]
    mirror = mirror_check(torch, out["backend"], promoted)
    t = out["tiers"]
    print(f"[serve {TIER_FP8}] served={out['served']} decode_steps="
          f"{out['decode_steps']} tiers: demotes {t['demotes']}, promotes "
          f"{t['promotes']}; mirror check ({mirror['dtype']} pool): "
          f"{mirror['blocks']} promoted blocks resident, bitwise equal; K1 "
          f"launches {launches['paged_attention']} + "
          f"{launches['paged_attention_merge']} (want {k1} + {k1})")
    if out["served"] != flag_value(TIERED, "--requests", 16) \
            or mirror["dtype"] != "torch.float8_e4m3fn" \
            or not (t["demotes"] > 0 and t["promotes"] > 0) \
            or launches["paged_attention"] != k1 \
            or launches["paged_attention_merge"] != k1:
        raise AssertionError(f"{TIER_FP8}: {out['served']} served, tiers "
                             f"{t}, mirror {mirror}, launches {launches}")
    return dict(served=out["served"], decode_steps=out["decode_steps"],
                tiers=t, mirror=mirror, launches=launches)


def serve_phase(torch, serve, arch: str, flags=()):
    """One full-width serve run with every launch count set to 0 just
    before it; checks the served tokens and that each kernel of the path
    launched as often as the run's counts say.  A tiered run must demote
    and promote and pass ``mirror_check``; a sharded run reports each
    shard (``main_paged`` prints them) and passes
    ``dispatch_order_check`` after its counts are read."""
    counters = kernel_counters()
    reset_counts(counters)
    with Promotions() as promoted:
        out = serve.main(serve_args(arch, flags))
    launches = read_counts(counters)
    name = run_name(arch, flags)
    cfg = out["cfg"]                  # as served: --layers cuts the depth
    L = cfg.n_layers
    moe_layers = L - cfg.n_dense_layers if cfg.is_moe else 0
    # the engine's prefills and decode steps, then the check's: each
    # checked sequence alone, and in bf16 all of them in one batch
    prefills = out["prefills"] + out["parity_checked"] \
        + out["parity_batch_prefills"]
    embeds = prefills + out["decode_steps"] + out["parity_decode_steps"] \
        + out["parity_batch_decode_steps"]
    k1 = L * out["decode_steps"] if out["decode"] == "kernel" else 0
    want = {"paged_attention": k1, "paged_attention_merge": k1,
            "ssd_scan": L * prefills if cfg.has_ssm else 0,
            "ssd_scan_passes": ssd_passes(cfg, out["prompts"]) * L
            * prefills,
            "gather_rows": embeds if cfg.vocab * cfg.d_model >= 1 << 22
            else 0,
            "grouped_matmul": 3 * moe_layers * embeds,
            "flash_attention": unwindowed_layers(cfg) * prefills,
            "mars_engine": 0, "dram_channel": 0,
            "flash_attention_bwd": 0, "embedding_grad_scatter": 0}
    print(f"[serve {name}] served={out['served']} decode_tokens="
          f"{out['decode_tokens']} engine_steps={out['steps']} "
          f"prefills={out['prefills']} decode_steps={out['decode_steps']} "
          f"parity prefills={out['parity_checked']} + "
          f"{out['parity_batch_prefills']} batched, parity decode steps="
          f"{out['parity_decode_steps']} + {out['parity_batch_decode_steps']} "
          f"batched wall={out['wall_s']:.3f}s "
          f"tokens/s={out['decode_tokens'] / out['wall_s']:.1f} "
          f"parity_mismatches={out['parity_mismatches']} largest deficit "
          f"{out['parity_max_deficit']:.5g}, dense noise median "
          f"{out['parity_noise']} layers={L}")
    print(f"[serve {name}] launches: " + ", ".join(
        f"{k} {launches[k]} (want {want[k]})" for k in counters))
    if "--tiered-kv" in flags:
        t = out["tiers"]
        out["mirror"] = mirror_check(torch, out["backend"], promoted)
        print(f"[serve {name}] tiers: demotes {t['demotes']}, promotes "
              f"{t['promotes']}, promoted_tokens {t['promoted_tokens']}, "
              f"modelled stall_us {t['stall_us']:.1f}; tier_probe "
              f"{'wired' if out['tier_probe'] else 'none'}; mirror check: "
              f"{out['mirror']['blocks']} promoted blocks resident, their "
              f"staged mirror pages equal the tier payloads bitwise")
        if not (t["demotes"] > 0 and t["promotes"] > 0
                and t["promoted_tokens"] > 0):
            raise AssertionError(f"{name}: the tiers never spilled and "
                                 f"re-promoted: {t}")
        if "--shards" in flags and not out["tier_probe"]:
            raise AssertionError(f"{name}: the scheduler's tier_probe is "
                                 f"not wired")
    if "--metrics" in flags:
        # the snapshot and trace written right after the engine's run
        out["metrics"] = metrics_check(out, name, flags)
    if "--shards" in flags and cfg.cdtype != torch.float32:
        out["dispatch"] = dispatch_order_check(torch, out)
    if out["served"] != flag_value(flags, "--requests", 16) \
            or out["parity_mismatches"]:
        raise AssertionError(f"{name}: {out['served']} served, "
                             f"{out['parity_mismatches']} parity mismatches")
    if launches != want or not all(
            launches[k] > 0 for k in want if want[k]):
        raise AssertionError(f"{name}: kernel launches {launches} on the "
                             f"main path, want {want}")
    bad = [t for toks in out["finished"].values() for seq in toks
           for t in seq if not 0 <= t < cfg.vocab]
    if bad or any(len(seq) != out["max_new"][rid]
                  for rid, toks in out["finished"].items() for seq in toks):
        raise AssertionError(f"{name}: served tokens out of range or of the "
                             f"wrong count")
    if cfg.has_ssm and cfg.cdtype != torch.float32:
        # the SSM prefill keeps its decay in f32 (models/ssm.py): how far
        # the served bf16 tokens sit from a float32 answer (the whole
        # sequence is forwarded: a hybrid's scan needs a multiple of its
        # chunk, and prompt + 8 tokens is one).  Not for the paged dense
        # and MoE runs: a float32 copy of deepseek-coder-33b's, kimi-k2's
        # or arctic's weights does not fit on the card beside them
        rids = sorted(out["finished"])
        dev = out["params"]["embed"]["tok"].device
        prompts = torch.tensor([out["prompts"][r] for r in rids],
                               dtype=torch.int32, device=dev)
        toks = torch.tensor([out["finished"][r][0] for r in rids],
                            dtype=torch.int32, device=dev)
        out["f32"] = f32_distance(torch, cfg, out["params"], [
            (torch.cat([prompts, toks], dim=1), prompts.shape[1], toks,
             None)])
        print_f32_distance(f"[serve {name}]", out["f32"])
    if cfg.is_moe and cfg.cdtype != torch.float32:
        # router near ties decide the teacher-forced check of a bf16 MoE
        # run; this one holds K4 on the run's own hidden states instead
        out["routed"] = routed_layer_check(torch, cfg, out)
        r = out["routed"]
        print(f"[serve {name}] routed layer (K4) on {r['tokens']} served "
              f"tokens against float32 math on the same weights and expert "
              f"choices: largest per-token relative error "
              f"{r['k4_max_rel']:.4g} (mean {r['k4_mean_rel']:.4g}); the "
              f"plain bf16 math's {r['plain_max_rel']:.4g} (mean "
              f"{r['plain_mean_rel']:.4g}); limit {ROUTED_NOISE_FACTOR} x "
              f"the plain's")
        if not r["k4_max_rel"] <= ROUTED_NOISE_FACTOR * r["plain_max_rel"]:
            raise AssertionError(f"{name}: the routed layer through K4 is "
                                 f"further from float32 than "
                                 f"{ROUTED_NOISE_FACTOR} x bf16 math: {r}")
    return out, launches


# How far from float32 math the routed layer through K4 may be, as a
# multiple of the plain bfloat16 math's own distance on the same inputs
ROUTED_NOISE_FACTOR = 2


class _Captured(Exception):
    """Stops a forward once the first MoE layer's input is read."""


def moe_layer_input(torch, cfg, params, seq):
    """The first MoE layer's parameters and the hidden states (B, S, d)
    that ``lm.forward`` of ``seq`` hands its routed experts."""
    from repro_torch.models import lm, moe
    apply, got = moe.moe_apply, []

    def capture(p, x, c):
        got.append((p, x))
        raise _Captured
    moe.moe_apply = capture
    try:
        with torch.no_grad():
            lm.forward(params, cfg, seq)
    except _Captured:
        pass
    finally:
        moe.moe_apply = apply
    return got[0]


def routed_layer_check(torch, cfg, out) -> dict:
    """K4 on a served MoE run's own data, with no router tie in the way:
    the served sequences (prompt + served tokens) are forwarded to the
    first MoE layer, whose routed experts then run through the serve
    path's dispatch (K4, in the compute dtype), through float32 math on
    the same weights and the same expert choices and gates, and through
    the same per-expert math in the compute dtype (the plain version).
    Reports each one's largest and mean per-token relative L2 distance
    from the float32 answer."""
    from repro_torch.models import layers, moe
    rids = sorted(out["finished"])
    dev = out["params"]["embed"]["tok"].device
    seq = torch.cat([
        torch.tensor([out["prompts"][r] for r in rids], dtype=torch.int32,
                     device=dev),
        torch.tensor([out["finished"][r][0] for r in rids],
                     dtype=torch.int32, device=dev)], dim=1)
    p, x = moe_layer_input(torch, cfg, out["params"], seq)
    cd, f32 = cfg.cdtype, torch.float32
    xf = x.reshape(-1, cfg.d_model)
    with torch.no_grad():
        idx, gates, _ = moe.router_topk(p, xf, cfg)
        got = moe._mars_dispatch_local(p, xf, cfg)[0].float()
        T, k = idx.shape
        parts = {dt: torch.empty(T, k, cfg.d_model, dtype=dt, device=dev)
                 for dt in (f32, cd)}
        for e in idx.unique().tolist():
            t, j = (idx == e).nonzero(as_tuple=True)
            for dt, part in parts.items():
                xe = xf[t].to(cd).to(dt)
                w_in, w_gate, w_out = (p[n][e].to(cd).to(dt)
                                       for n in ("w_in", "w_gate", "w_out"))
                h = layers._act(xe @ w_gate, cfg.act) * (xe @ w_in)
                part[t, j] = h @ w_out
        ref = (parts[f32] * gates.float()[..., None]).sum(1)
        plain = (parts[cd] * gates.to(cd)[..., None]).sum(1).float()
        norm = ref.norm(dim=-1).clamp_min(1e-30)
        k4 = (got - ref).norm(dim=-1) / norm
        bf = (plain - ref).norm(dim=-1) / norm
    return dict(tokens=T, k4_max_rel=float(k4.max()),
                k4_mean_rel=float(k4.mean()), plain_max_rel=float(bf.max()),
                plain_mean_rel=float(bf.mean()))


def ssd_passes(cfg, prompts) -> int:
    """K3's extra launches a prefill of these prompts takes in an SSM
    layer: 2 when the scan has more than one chunk, else 0 (one length
    for every prompt, as the serve load draws them)."""
    lengths = {len(p) for p in (prompts.values() if isinstance(
        prompts, dict) else prompts)}
    S, = lengths
    return 2 if cfg.has_ssm and S > cfg.ssm_chunk else 0


def unwindowed_layers(cfg) -> int:
    """Decoder layers whose prefill attention is plain causal (through
    flash_attention): all of them, or a windowed model's global ones."""
    if not cfg.has_attention:
        return 0
    if not cfg.sliding_window:
        return cfg.n_layers
    return sum(1 for li in range(cfg.n_layers)
               if cfg.global_every and li % cfg.global_every == 0)


def kernel_counters() -> dict:
    """Each kernel of the port by name, as (wrapper, attribute) of the
    count its wrapper adds one to where it launches the kernel; K1's merge
    pass has its own count on the same wrapper, and so have K3's state
    pass and output pass (two a call of more than one chunk)."""
    from repro_torch.kernels.dram_channel import dram_channel as dc_mod
    from repro_torch.kernels.flash_attention import flash_attention as k5_mod
    from repro_torch.kernels.mars_engine import mars_engine as me_mod
    from repro_torch.kernels.mars_gather import mars_gather as mg_mod
    from repro_torch.kernels.moe_dispatch import moe_dispatch as k4_mod
    from repro_torch.kernels.paged_attention import paged_attention as pa_mod
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
    return {"paged_attention": (pa_mod.paged_attention, "launches"),
            "paged_attention_merge": (pa_mod.paged_attention,
                                      "merge_launches"),
            "ssd_scan": (ssd_mod.ssd_scan, "launches"),
            "ssd_scan_passes": (ssd_mod.ssd_scan, "pass_launches"),
            "gather_rows": (mg_mod.gather_rows, "launches"),
            "grouped_matmul": (k4_mod.grouped_matmul, "launches"),
            "flash_attention": (k5_mod.flash_attention, "launches"),
            "mars_engine": (me_mod.mars_engine, "launches"),
            "dram_channel": (dc_mod.dram_channels, "launches"),
            "flash_attention_bwd": (k5_mod.flash_attention_bwd, "launches"),
            "embedding_grad_scatter": (mg_mod.scatter_add_rows,
                                       "launches")}


def reset_counts(counters: dict) -> None:
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)


def read_counts(counters: dict) -> dict:
    return {k: getattr(w, a) for k, (w, a) in counters.items()}


def free_device(torch, tag: str) -> None:
    """Drop what the last run left (its weights go with its frames) and
    return the cached blocks, so the next run can take the card; prints
    what stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[memory] after {tag}: {torch.cuda.memory_allocated() / 2**30:.3f}"
          f" GiB allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
          f"reserved")


def profile_serve(torch, serve, args) -> dict:
    """The serve run twice more, warm: once plain (engine wall time), once
    with ``torch.profiler`` around the engine's run alone — not the random
    init of the weights, which at arctic-480b's width writes 55 GB — for
    the summed device time by kernel and its share of the engine's wall,
    and the host ops with the most self time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import ServeEngine
    args = args + ["--parity-checks", "0"]
    t0 = time.perf_counter()
    warm = serve.main(args)              # warm, no profiler
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    warm = {k: v for k, v in warm.items() if k not in NOT_STATS}
    free_device(torch, "warm profile run")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run = ServeEngine.run
    walls = []

    def profiled_run(self, *a, **kw):
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        try:
            return run(self, *a, **kw)
        finally:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            prof.stop()
    ServeEngine.run = profiled_run
    try:
        serve.main(args)
    finally:
        ServeEngine.run = run
    wall, = walls
    return dict(warm_engine_wall_s=warm["wall_s"], warm_wall_s=warm_wall,
                warm_decode_tokens=warm["decode_tokens"],
                warm_decode_steps=warm["decode_steps"],
                **profile_summary(prof, wall))


def raw_rows(prof) -> tuple:
    """The device rows (kernels, copies) of a finished profile and its
    host ops with their self time, each row a name, summed ms and count,
    longest first, read from the profiler's raw events: building its
    event tree (``key_averages``) for a serve run of hundreds of
    thousands of events took most of a profiled run's time on the H100.
    A host op's self time is its duration less that of the ops nested in
    it on its thread."""
    from torch.autograd import DeviceType
    dev, host, threads = {}, {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            r = dev.setdefault(e.name(), [0, 0])
            r[0] += e.duration_ns()
            r[1] += 1
        elif e.device_type() == DeviceType.CPU and not e.is_async():
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), e.name()))

    def close(op):
        r = host.setdefault(op[1], [0, 0])
        r[0] += op[2]
        r[1] += 1
    for ops in threads.values():
        ops.sort()
        stack = []                      # open ops: [end, name, self ns]
        for start, neg_end, name in ops:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            end = -neg_end
            if stack:
                stack[-1][2] -= min(end, stack[-1][0]) - start
            stack.append([end, name, end - start])
        for op in stack:
            close(op)

    def rows(d):
        return sorted((dict(name=k, ms=v[0] / 1e6, calls=v[1])
                       for k, v in d.items() if v[0] > 0),
                      key=lambda r: -r["ms"])
    return rows(dev), rows(host)


def profile_summary(prof, wall: float) -> dict:
    """Device time by kernel and by kind, busy share over ``wall`` and
    the host ops with the most self time of a finished profile."""
    rows, host = raw_rows(prof)
    if not rows:
        raise Unread("serve profile: torch.profiler recorded no device time")
    buckets: dict = {}
    for r in rows:
        n = r["name"].lower()
        b = ("paged_attention_merge" if "paged_attention_merge" in n else
             "paged_attention" if "paged_attention" in n else
             "ssd_scan" if "ssd_scan_" in n else
             "grouped_matmul" if "grouped_mm_" in n else
             "gather_rows" if "gather_rows_kernel" in n else
             "flash_attention" if "flash_attn_" in n else
             "flash_attention_bwd" if "flash_bwd_" in n else
             "embedding_grad_scatter" if "embedding_grad_scatter" in n else
             "memcpy" if "memcpy" in n or "memset" in n else
             "gemm" if any(k in n for k in ("gemm", "nvjet", "cutlass",
                                            "xmma", "cublas")) else
             "other")
        buckets[b] = buckets.get(b, 0.0) + r["ms"]
    dev_ms = sum(r["ms"] for r in rows)
    return dict(wall_s=wall, device_ms=dev_ms,
                busy_share=dev_ms / 1e3 / wall,
                kernel_calls={k: sum(r["calls"] for r in rows
                                     if key in r["name"])
                              for k, key in KERNEL_NAMES.items()},
                by_kind_ms=buckets, top=rows[:12],
                host_ms=sum(r["ms"] for r in host), host_top=host[:12])


def dense_launches_wanted(cfg, prefills: int, steps: int) -> dict:
    """Launches of each kernel on a dense-backend run of ``prefills``
    batches and ``steps`` decode steps: flash_attention over the encoder,
    the decoder's causal prefill and its cross-attention at prefill and
    at every step (a VLM's text-only decoder: once a layer a prefill, no
    cross term); ssd_scan in every SSM layer's prefill; gather_rows in
    every embedding lookup of a large table."""
    L = cfg.n_layers
    cross = L if cfg.family == "encdec" else 0
    return {"paged_attention": 0, "paged_attention_merge": 0,
            "ssd_scan": L * prefills if cfg.has_ssm else 0,
            "ssd_scan_passes": 0,
            "gather_rows": prefills + steps
            if cfg.vocab * cfg.d_model >= 1 << 22 else 0,
            "grouped_matmul": 0,
            "flash_attention": prefills * (cfg.enc_layers
                                           + unwindowed_layers(cfg) + cross)
            + steps * cross,
            "mars_engine": 0, "dram_channel": 0,
            "flash_attention_bwd": 0, "embedding_grad_scatter": 0}


def _to_f32(tree):
    """A copy of a parameter tree with its floating tensors in float32."""
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_f32(v) for v in tree)
    if hasattr(tree, "is_floating_point") and tree.is_floating_point():
        return tree.float()
    return tree


def f32_distance(torch, cfg, params, batches) -> dict:
    """How far a bfloat16 run's served tokens sit from a float32 answer on
    the same weights: each batch ``(seq, S, tokens, frontend)`` (prompt +
    served tokens, at least all but the last; prompt length; served
    tokens (B, n); frame embeddings or None) is teacher-forced through ``lm.forward``
    with the weights cast to float32, in float32, and through the run's
    own bfloat16 ``lm.forward``.  Reports, over all positions, the largest
    float32 deficit of the served tokens (f32 top logit minus the f32
    logit of the served token) and how many are not the f32 argmax, and
    the same for the bf16 forward's own argmax — the distance bfloat16
    math alone puts between the model and its float32 answer."""
    import dataclasses
    from repro_torch.models import lm
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = _to_f32(params)
    served_def, bf16_def, served_off, bf16_off, positions = [], [], 0, 0, 0
    with torch.no_grad():
        for seq, S, toks, fe in batches:
            at = slice(S - 1, S - 1 + toks.shape[1])
            l32 = lm.forward(p32, cfg32, seq,
                             None if fe is None else fe.float())[:, at]
            l16 = lm.forward(params, cfg, seq, fe)[:, at]
            top = l32.amax(-1)
            arg16 = l16.argmax(-1)
            arg32 = l32.argmax(-1)
            served_def.append(float(
                (top - l32.gather(-1, toks[..., None].long())[..., 0])
                .max()))
            bf16_def.append(float(
                (top - l32.gather(-1, arg16[..., None])[..., 0]).max()))
            served_off += int((toks.long() != arg32).sum())
            bf16_off += int((arg16 != arg32).sum())
            positions += toks.numel()
    del p32
    return dict(positions=positions, served_max_deficit=max(served_def),
                served_not_argmax=served_off,
                bf16_forward_max_deficit=max(bf16_def),
                bf16_forward_not_argmax=bf16_off)


def print_f32_distance(tag: str, d: dict) -> None:
    print(f"{tag} against the float32 forward on the same weights: served "
          f"tokens largest deficit {d['served_max_deficit']:.4g}, "
          f"{d['served_not_argmax']}/{d['positions']} positions off the "
          f"f32 argmax; the bf16 forward's own argmax: largest deficit "
          f"{d['bf16_forward_max_deficit']:.4g}, "
          f"{d['bf16_forward_not_argmax']}/{d['positions']} off")


def forward_frontend(torch, cfg, o):
    """What ``lm.forward`` reads beside a served batch's tokens: the
    batch's frame embeddings, or for a VLM, which served its text-only
    decoder, an empty (B, 0, d) image prefix (the same model)."""
    if cfg.family != "vlm":
        return o["frontend"]
    p = o["prompts"]
    return torch.zeros((p.shape[0], 0, cfg.d_model), dtype=cfg.cdtype,
                       device=p.device)


def dense_check(torch, serve, out) -> dict:
    """Teacher-force every served batch through ``lm.forward`` (prompt +
    served tokens but the last, the batch's frame embeddings or a VLM's
    empty image prefix, ``forward_frontend``) and hold
    each served token against the forward logits before it: exact argmax
    in float32; in bfloat16 within ``serve.near_tie_margin`` or
    ``serve.NOISE_FACTOR`` times the median dense noise (the largest
    logit change between forwarding each sequence alone and the whole
    batch), whichever is larger, as the paged runs' check."""
    import numpy as np
    from repro_torch.models import lm
    cfg, params = out["cfg"], out["params"]
    batches = [o for mars in (False, True) for o in out[mars]["outputs"]]
    dense, noise = [], []
    with torch.no_grad():
        for o in batches:
            S = o["prompts"].shape[1]
            seq = torch.cat([o["prompts"], o["tokens"][:, :-1]], dim=1)
            fe = forward_frontend(torch, cfg, o)
            logits = lm.forward(params, cfg, seq, fe)[:, S - 1:].float()
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite forward logits")
            dense.append(logits.cpu().numpy())
            if cfg.cdtype != torch.float32:
                for i in range(seq.shape[0]):
                    one = lm.forward(params, cfg, seq[i:i + 1],
                                     None if fe is None else fe[i:i + 1])
                    noise.append((one[0, S - 1:].float() - logits[i]).abs()
                                 .amax(-1).cpu().numpy())
    noise_scale = float(np.median(np.concatenate(noise))) if noise else None
    mismatches = exact = positions = 0
    max_deficit = max_margin = 0.0
    for o, d in zip(batches, dense):
        toks = o["tokens"].cpu().numpy()
        for b in range(toks.shape[0]):
            margin = serve.near_tie_margin(d[b], cfg.cdtype)
            if noise_scale is not None:
                margin = np.maximum(margin, serve.NOISE_FACTOR * noise_scale)
            deficit = d[b].max(-1) - d[b][np.arange(toks.shape[1]), toks[b]]
            positions += toks.shape[1]
            exact += int((deficit == 0).all())
            mismatches += int((deficit > margin).any())
            max_deficit = max(max_deficit, float(deficit.max()))
            max_margin = max(max_margin, float(margin.max()))
    return dict(sequences=sum(o["tokens"].shape[0] for o in batches),
                positions=positions, exact=exact, mismatches=mismatches,
                max_deficit=max_deficit, max_margin=max_margin,
                noise=noise_scale)


def dense_phase(torch, serve, arch: str, flags=()):
    """One dense-backend serve run (``mars=False``, then ``mars=True``)
    with every launch count set to 0 just before it; checks each kernel
    of the path launched as often as the run's batches and steps say,
    then the served tokens (``dense_check``)."""
    counters = kernel_counters()
    reset_counts(counters)
    out = serve.main(dense_args(arch, flags))
    launches = read_counts(counters)
    name = run_name(arch, flags)
    cfg = out["cfg"]
    runs = [out[False], out[True]]
    batches = [o for r in runs for o in r["outputs"]]
    prefills = len(batches)
    steps = sum(o["tokens"].shape[1] - 1 for o in batches)
    want = dense_launches_wanted(cfg, prefills, steps)
    want["ssd_scan_passes"] = sum(
        ssd_passes(cfg, o["prompts"].tolist()) for o in batches) \
        * cfg.n_layers
    tokens = sum(o["tokens"].numel() for o in batches)
    wall = sum(r["wall_s"] for r in runs)
    print(f"[dense {name}] served={[r['served'] for r in runs]} batches="
          f"{[r['batches'] for r in runs]} unique prefix blocks/batch="
          f"{[r['blocks_per_batch'] for r in runs]} prefills={prefills} "
          f"decode_steps={steps} generated_tokens={tokens} wall={wall:.3f}s "
          f"tokens/s={tokens / wall:.1f} layers={cfg.n_layers}"
          f"+{cfg.enc_layers} enc")
    print(f"[dense {name}] launches: " + ", ".join(
        f"{k} {launches[k]} (want {want[k]})" for k in counters))
    bad = [o for o in batches if o["tokens"].shape != (
        o["prompts"].shape[0], 9) or not bool(
        ((o["tokens"] >= 0) & (o["tokens"] < cfg.vocab)).all())]
    if any(r["served"] != 16 for r in runs) or bad:
        raise AssertionError(f"{name}: served {[r['served'] for r in runs]}"
                             f", {len(bad)} batches with tokens out of range "
                             f"or of the wrong count")
    if launches != want or not all(
            launches[k] > 0 for k in want if want[k]):
        raise AssertionError(f"{name}: kernel launches {launches} on the "
                             f"main path, want {want}")
    check = dense_check(torch, serve, out)
    print(f"[dense {name}] teacher-forced check against lm.forward: "
          f"{check['sequences'] - check['mismatches']}/{check['sequences']} "
          f"sequences match ({check['exact']} argmax-exact over "
          f"{check['positions']} positions, largest deficit "
          f"{check['max_deficit']:.4g}, margin<={check['max_margin']:.4g}, "
          f"dense noise median {check['noise']})")
    if check["mismatches"]:
        raise AssertionError(f"{name}: {check['mismatches']} served "
                             f"sequences fail the teacher-forced check")
    if cfg.cdtype != torch.float32:
        check["f32"] = f32_distance(torch, cfg, out["params"], [
            (torch.cat([o["prompts"], o["tokens"][:, :-1]], dim=1),
             o["prompts"].shape[1], o["tokens"],
             forward_frontend(torch, cfg, o)) for o in batches])
        print_f32_distance(f"[dense {name}]", check["f32"])
    stats = dict(served=[r["served"] for r in runs],
                 batches=[r["batches"] for r in runs],
                 blocks_per_batch=[r["blocks_per_batch"] for r in runs],
                 wall_s=wall, prefills=prefills, decode_steps=steps,
                 generated_tokens=tokens, check=check)
    return stats, launches


def profile_dense(torch, serve, args) -> dict:
    """The dense run twice more, warm: once plain (its serve walls), once
    with ``torch.profiler`` from the first batch's prefill to the end of
    the run — not the weights' init — for the device time by kernel and
    its busy share of that wall."""
    from torch.profiler import ProfilerActivity, profile
    warm = serve.main(args)
    warm_wall = sum(warm[m]["wall_s"] for m in (False, True))
    tokens = sum(o["tokens"].numel() for m in (False, True)
                 for o in warm[m]["outputs"])
    steps = sum(o["tokens"].shape[1] - 1 for m in (False, True)
                for o in warm[m]["outputs"])
    del warm
    free_device(torch, "warm profile run")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    generate = serve.greedy_generate
    t0 = []

    def profiled(*a, **kw):
        if not t0:
            torch.cuda.synchronize()
            prof.start()
            t0.append(time.perf_counter())
        return generate(*a, **kw)
    serve.greedy_generate = profiled
    try:
        out = serve.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0[0]
        prof.stop()
    finally:
        serve.greedy_generate = generate
    del out
    return dict(warm_engine_wall_s=warm_wall, warm_decode_tokens=tokens,
                warm_decode_steps=steps, **profile_summary(prof, wall))


# -- the train phase ---------------------------------------------------------
# B5 cases: (name, B, Sq, Sk, H, D, causal).  qwen1.5-0.5b's attention in
# the training run (batch 8 x 512, 16 heads of 64, causal), a long causal
# case, whisper-base's encoder (8 x 1500 frames, 8 heads of 64, no
# mask), its cross-attention (512 decoder positions over 1500 frames)
# and its causal decoder, and head dim 128 with ragged tiles (no mask, Sq
# != Sk; and causal).
B5_CASES = [("qwen", 8, 512, 512, 16, 64, True),
            ("long_causal", 1, 4096, 4096, 16, 64, True),
            ("whisper_encoder", 8, 1500, 1500, 8, 64, False),
            ("whisper_cross", 8, 512, 1500, 8, 64, False),
            ("whisper_decoder", 8, 512, 512, 8, 64, True),
            ("ragged_d128", 2, 200, 300, 4, 128, False),
            ("causal_d128", 2, 300, 300, 4, 128, True)]
# B5 against its plain twin, per element of each gradient, (atol, rtol):
# |got - want| <= atol max|want| + rtol |want|, max over the gradient.
# Both compute the same f32 products from the same inputs and differ in
# summation order (up to 4096 terms) and in how the row log-sum-exp is
# taken (an online max and sum over 64-key tiles against one logsumexp):
# 1e-4 of the largest value and of each value.  In bfloat16 each side
# then rounds its f32 value to bf16 once, which may land one bf16 spacing
# (2**-7 relative) apart.
B5_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 2.0 ** -7)}
# In bfloat16 B5 and its twin also round p (before p^T do) and ds (before
# ds k, ds^T q) to bf16, each from f32 values that differ in their last
# bits (summation order; exp2 against exp): a value that lies near a bf16
# rounding midpoint may land one bf16 spacing apart on the two sides.  A
# flipped ds of 0.9 moves a dq element by 2**-7 * 0.9 * |k| / 8, ~1e-3,
# where dq may be 0.03 (whisper's encoder on the H100), beyond B5_TOL.  So
# in bf16 the bound per element adds to B5_TOL's what such flips can move
# it (``b5_bounds``): every p or ds of the twin whose f32 value lies within
# a margin of a midpoint counts as flipped, by a spacing plus the margin,
# into dv (times |do|), dq (times |k| scale) and dk (times |q| scale).  The
# margin is 2**-16 of p, and for ds also 2**-16 p (|do|.|v| + |do|.|o|):
# the two sides' f32 p differ by a few 2**-23 relative, and dp and delta
# (64-term dot products) by at most 64 2**-24 of those sums.
B5_FLIP_MARGIN = 2.0 ** -16
# B2 cases: the training runs' tables (qwen1.5-0.5b's 151936 x 1024,
# whisper-base's 51865 x 512) with a batch of 8 x 512 ids from
# TokenStream (zipf: id 1 takes about a quarter) and uniform ids.  B2 must
# equal its twin on host copies bit for bit (both sum in f32 in sorted
# order); against the twin on the card (index_add_ adds with atomics, in
# another order) per element as B5: (atol, rtol) of 1e-5 in f32, and one
# bf16 spacing in bfloat16.
B2_TABLES = {"qwen": (151936, 1024), "whisper": (51865, 512)}
# B2's worst cases beside them, bitwise too: every token the same id (one
# run of 4096 on qwen's table, summed by 16 warps side by side, 128 batches
# of 32 rows deep), and widths that no warp's 64 columns divide: 1000
# (the last warp sums 40 of its 64) and the odd 999 (one column a lane),
# qwen's vocabulary, zipf ids.  (name, V, d, ids: "one_id" or "zipf")
B2_WORST = (("qwen", 151936, 1024, "one_id"),
            ("width_1000", 151936, 1000, "zipf"),
            ("width_999", 151936, 999, "zipf"))
B2_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
TRAIN_TOKENS = (8, 512)             # batch x sequence of the training runs
# The training runs at full width, bf16: (config, steps, checkpoint
# interval, the step a second run is killed at, extra flags).  The killed
# run resumes with --resume from its last checkpoint and must end at the
# uninterrupted run's last loss within the reference's rtol (1e-4,
# tests/test_ft.py:134).  whisper-base reads stub frames (normal * 0.02,
# drawn per step): with the reference's zero frames every encoder
# LayerNorm sees zero variance, the global gradient norm overflows to
# inf and the clip zeroes every update, in the reference as in the port
# (ROADMAP.md §3), so nothing would train.
TRAIN_RUNS = (("qwen1_5_0_5b", 30, 10, 20, ()),
              ("whisper_base", 12, 4, 8, ("--frontend", "stub")))
TRAIN_RESUME_RTOL = 1e-4
# configs whose CUDA training forward would launch a kernel with no
# backward kernel (K3, K4): launch.train must refuse them
TRAIN_REFUSED = ("hymba_1_5b", "mamba2_370m", "arctic_480b")
# The float32 step at full width on the card against the same step on
# host copies (the CPU's twins): qwen1.5-0.5b, batch 2 x 128.  Both run
# the same f32 arithmetic in other orders and libraries through 24
# layers: the loss within 1e-4 relative, each gradient leaf within
# 1e-3 of its largest value; remat on against off on the card to the
# same bound (the recomputed forward repeats the same kernels).
F32_TRAIN = ("qwen1_5_0_5b", 2, 128)
F32_LOSS_RTOL = 1e-4
F32_GRAD_TOL = 1e-3


def bwd_err(got, want, tol) -> tuple:
    """Largest |got - want| and its largest ratio to the bound ``atol
    max|want| + rtol |want|``."""
    atol, rtol = tol
    w = want.float()
    diff = (got.float() - w).abs()
    bound = atol * float(w.abs().max()) + rtol * w.abs()
    return float(diff.max()), float((diff / bound.clamp_min(1e-30)).max())


def bf16_flip(torch, x, margin):
    """Per element of the float32 ``x``, the most its bf16 rounding can
    differ from that of a value within ``margin`` of it: 0 where x lies
    further than ``margin`` from a rounding midpoint (both round alike),
    else a bf16 spacing plus the margin."""
    m, e = torch.frexp(x)                  # |x| in [2**(e-1), 2**e)
    ulp = torch.ldexp(torch.ones_like(x), e - 24)
    dist = (x.view(torch.int32) & 0xFFFF).sub_(0x8000).abs_().float() \
        .mul_(ulp)
    near = dist <= margin + ulp
    return torch.where(near, torch.ldexp(torch.ones_like(x), e - 8) + margin,
                       torch.zeros_like(x))


def b5_bounds(k5, q, k, v, o, do, lse, causal: bool, want) -> list:
    """The bound per element of |B5 - twin| for (dq, dk, dv): ``B5_TOL``'s
    atol max|want| + rtol |want|, and in bfloat16 the most the p and ds
    that lie near a bf16 rounding midpoint can move each gradient by
    rounding the other way (see ``B5_FLIP_MARGIN``), from the twin's p
    and ds on these inputs."""
    import torch
    atol, rtol = B5_TOL[str(q.dtype).split(".")[-1]]
    bounds = [w.float().abs().mul_(rtol).add_(atol * float(w.float().abs()
                                                            .max()))
              for w in want]
    if q.dtype != torch.bfloat16:
        return bounds
    s, keep = k5._masked_scores(q, k, causal)
    if keep is not None:
        s.masked_fill_(~keep, float("-inf"))
    p = s.sub_(lse[..., None]).exp_()
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, v.float()).sub_(delta).mul_(p)
    margin = torch.einsum("bqhd,bkhd->bhqk", dof.abs(), v.float().abs()) \
        .add_((dof.abs() * o.float().abs()).sum(-1).transpose(1, 2)[..., None])
    margin.mul_(p).add_(ds.abs()).mul_(B5_FLIP_MARGIN)
    flip = bf16_flip(torch, ds, margin)
    del ds, margin
    scale = 1.0 / q.shape[-1] ** 0.5
    bounds[0] += scale * torch.einsum("bhqk,bkhd->bqhd", flip,
                                      k.float().abs())
    bounds[1] += scale * torch.einsum("bhqk,bqhd->bkhd", flip,
                                      q.float().abs())
    flip = bf16_flip(torch, p, p * B5_FLIP_MARGIN)
    bounds[2] += torch.einsum("bhqk,bqhd->bkhd", flip, dof.abs())
    return bounds


def bound_err(got, want, bound) -> tuple:
    """Largest |got - want| and its largest ratio to the bound per
    element ``bound``."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), float((diff / bound.clamp_min(1e-30)).max())


def b5_bound(q, k, causal: bool, dtype: str) -> dict:
    """B5's bound at one case: q, o, do and k, v read once, dq, dk, dv
    written once, over the memory rate; and 10 D operations for each
    (query, key) pair the mask keeps (q.k, do.v, p^T do, ds k, ds^T q)
    over the dtype's peak; the larger."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
    ops_count = 10 * pairs * D
    bytes_moved = 4 * (q.numel() + k.numel()) * q.element_size()
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, ops=ops_count, pairs=pairs)


def b5_phase(torch, F, gen):
    """B5 (flash_attention_bwd) against its plain twin on the card at
    every case, float32 and bfloat16, o and lse from K5; in bfloat16 also
    B5's and SDPA backward's distance from the unrounded float32 twin
    (``f32_reference_err``); times every case beside its bound, the twin
    and SDPA's backward."""
    from repro_torch.kernels.flash_attention import flash_attention as k5
    results, timing, max_err = [], {}, 0.0
    for dtype in ("float32", "bfloat16"):
        for name, B, Sq, Sk, H, D, causal in B5_CASES:
            dt = getattr(torch, dtype)
            q, k, v = k5_inputs(torch, gen, B, Sq, Sk, H, D, dt)
            do = torch.randn(q.shape, generator=gen, device=gen.device) \
                .to(dt)
            o, lse = k5.flash_attention_with_lse(q, k, v, causal=causal)
            got = k5.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                         lse=lse)
            torch.cuda.synchronize()
            want = k5.flash_attention_bwd_plain(q, k, v, o, do,
                                                causal=causal, lse=lse)
            bounds = b5_bounds(k5, q, k, v, o, do, lse, causal, want)
            errs = [bound_err(g, w, b) for g, w, b in zip(got, want, bounds)]
            del bounds
            plain_use = [bwd_err(g, w, B5_TOL[dtype])[1]
                         for g, w in zip(got, want)]
            ok = all(e[1] <= 1.0 for e in errs) and all(
                bool(torch.isfinite(g.float()).all()) and g.dtype == dt
                and g.shape == w.shape for g, w in zip(got, want))
            err = max(e[0] for e in errs)
            print(f"[train] flash_attention_bwd {name:15s} {dtype:8s} B={B} "
                  f"Sq={Sq} Sk={Sk} H={H} D={D} causal={causal}: dq/dk/dv "
                  f"err " + " / ".join(f"{e[0]:.3e}" for e in errs)
                  + f", largest err/tol " + " / ".join(
                      f"{e[1]:.3f}" for e in errs)
                  + f" (tol atol*max|want| + rtol|want|, "
                  f"(atol, rtol)={B5_TOL[dtype]}"
                  + (", + the bf16 flips of p and ds (b5_bounds); against "
                     "(atol, rtol) alone " + " / ".join(
                         f"{x:.3f}" for x in plain_use)
                     if dtype == "bfloat16" else "")
                  + f") {'ok' if ok else 'MISMATCH'}")
            results.append(dict(case=name, dtype=dtype, err=err,
                                err_over_tol=[e[1] for e in errs],
                                err_over_b5_tol=plain_use, ok=ok))
            max_err = max(max_err, err)
            del want
            if dtype == "bfloat16":
                ref = f32_reference_err(torch, F, k5, q, k, v, do, got,
                                        causal)
                print(f"[train] flash_attention_bwd {name:15s} bfloat16 "
                      f"against the unrounded float32 twin: largest "
                      f"|err| dq/dk/dv B5 " + " / ".join(
                          f"{e:.3e}" for e in ref["b5"]) + ", SDPA backward "
                      + " / ".join(f"{e:.3e}" for e in ref["sdpa"])
                      + f" (B5 / SDPA {ref['ratio']:.3f}); relative rms "
                      f"B5 " + " / ".join(f"{e:.2e}" for e in ref["b5_rms"])
                      + ", SDPA " + " / ".join(
                          f"{e:.2e}" for e in ref["sdpa_rms"]))
                results[-1]["f32_reference"] = ref
            del got
            timing[f"{name}/{dtype}"] = time_b5(torch, F, k5, q, k, v, o,
                                                do, lse, causal, dtype,
                                                f"{name}/{dtype}")
            del q, k, v, o, do, lse
            torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain "
                             f"twin: {bad}")
    return results, max_err, timing


def f32_reference_err(torch, F, k5, q, k, v, do, got, causal: bool) -> dict:
    """How far B5's bfloat16 gradients ``got`` and SDPA backward's (on
    the same bf16 inputs, (B, H, S, D) copies, its own forward) lie from
    the unrounded twin: ``flash_attention_bwd_plain`` on the inputs
    widened to float32, o from the float32 forward twin, nothing
    rounded.  Largest |err| of dq, dk, dv each, and the ratio of the two
    largest; and each gradient's root-mean-square error over the
    reference's root-mean-square (the largest errors sit at the output's
    own bf16 rounding, the same for both)."""
    wide = [t.float() for t in (q, k, v, do)]
    o32 = k5.flash_attention_plain(*wide[:3], causal=causal)
    ref = k5.flash_attention_bwd_plain(*wide[:3], o32, wide[3],
                                       causal=causal)
    del o32
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    lib = [g.transpose(1, 2) for g in torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2).contiguous())]
    b5 = [float((g.float() - r).abs().max()) for g, r in zip(got, ref)]
    sdpa = [float((g.float() - r).abs().max()) for g, r in zip(lib, ref)]

    def rms(g, r):
        return float((g.float() - r).pow(2).mean().sqrt()
                     / r.pow(2).mean().sqrt().clamp_min(1e-30))
    return dict(b5=b5, sdpa=sdpa, ratio=max(b5) / max(max(sdpa), 1e-30),
                b5_rms=[rms(g, r) for g, r in zip(got, ref)],
                sdpa_rms=[rms(g, r) for g, r in zip(lib, ref)])


def time_b5(torch, F, k5, q, k, v, o, do, lse, causal: bool, dtype: str,
            case: str) -> dict:
    """B5, its plain twin and SDPA's backward (``torch.autograd.grad``
    of ``scaled_dot_product_attention`` on (B, H, S, D) copies, the
    forward run beforehand; never called by the port) at one case,
    beside ``b5_bound``; and K5 at this training shape with and without
    the lse output (``fwd_ms``, ``fwd_nolse_ms``)."""
    bound = b5_bound(q, k, causal, dtype)
    long = bound["pairs"] > 1 << 27
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2).contiguous()

    def kern():
        k5.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)

    def plain():
        k5.flash_attention_bwd_plain(q, k, v, o, do, causal=causal, lse=lse)

    def lib():
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    def fwd():
        k5.flash_attention_with_lse(q, k, v, causal=causal)

    def fwd_nolse():
        k5.flash_attention(q, k, v, causal=causal)
    return dict(fwd_ms=counted_ms(fwd, 10, f"flash_attention with lse {case}",
                                  "flash_attn_", 1, tag="[train]"),
                fwd_nolse_ms=counted_ms(fwd_nolse, 10,
                                        f"flash_attention {case}",
                                        "flash_attn_", 1, tag="[train]"),
                ms=counted_ms(kern, 10, f"flash_attention_bwd {case}",
                              "flash_bwd_", k5.BWD_LAUNCHES, tag="[train]"),
                plain_ms=device_ms(plain, 2 if long else 5,
                                   f"flash_attention_bwd twin {case}"),
                library_ms=device_ms(lib, 10, f"SDPA backward {case}"),
                **bound)


def b2_phase(torch, gen):
    """B2 (embedding_grad_scatter) against its plain twin on host copies
    (bitwise) and on the card (``B2_TOL``), on the training runs' tables
    with TokenStream's zipf ids and uniform ids, float32 and bfloat16;
    then ``B2_WORST``; times every case beside its bound, the twin on the
    card and ``F.embedding``'s backward."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels.mars_gather import ops
    B, S = TRAIN_TOKENS

    def zipf(V):
        return next(TokenStream(DataConfig(vocab=V, seq_len=S,
                                           global_batch=B)))["tokens"]
    cases = []
    for tname, (V, D) in B2_TABLES.items():
        uniform = np.random.default_rng(3).integers(0, V, (B, S)) \
            .astype(np.int32)
        cases += [(tname, V, D, "zipf", zipf(V)),
                  (tname, V, D, "uniform", uniform)]
    for tname, V, D, kind in B2_WORST:
        cases.append((tname, V, D, kind, np.full((B, S), 1, np.int32)
                      if kind == "one_id" else zipf(V)))
    results, timing = [], {}
    for tname, V, D, ids_name, ids_np in cases:
        ids = torch.from_numpy(ids_np).cuda()
        longest = int(np.bincount(ids_np.ravel()).max())
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            g = torch.randn(B, S, D, generator=gen,
                            device=gen.device).to(dt)
            got = ops.embedding_grad_scatter(ids, g, V)
            torch.cuda.synchronize()
            host = ops.embedding_grad_scatter_plain(ids.cpu(), g.cpu(), V)
            bits = getattr(torch, _BITS[dtype])
            bitwise = bool(torch.equal(got.cpu().view(bits),
                                       host.view(bits)))
            host_err = float((got.cpu().float() - host.float()).abs()
                             .max())
            card = ops.embedding_grad_scatter_plain(ids, g, V)
            err, use = bwd_err(got, card, B2_TOL[dtype])
            ok = bitwise and use <= 1.0 and got.dtype == dt \
                and got.shape == (V, D)
            case = f"{tname}/{ids_name}/{dtype}"
            print(f"[train] embedding_grad_scatter {case}: {B}x{S} ids "
                  f"(longest run {longest}) into {V}x{D}: "
                  f"{'bitwise equal' if bitwise else 'DIFFERENT'} to "
                  f"the twin on host copies; against the twin on the "
                  f"card err {err:.3e} (largest err/tol {use:.3f}, "
                  f"(atol, rtol)={B2_TOL[dtype]}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            results.append(dict(case=case, bitwise=bitwise, err=err,
                                host_err=host_err, err_over_tol=use,
                                longest_run=longest, ok=ok))
            del got, host, card
            timing[case] = time_b2(torch, ops, ids, g, V, case)
            del g
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"embedding_grad_scatter disagrees with its "
                             f"plain twin: {bad}")
    return results, timing


def time_b2(torch, ops, ids, g, V: int, case: str) -> dict:
    """B2 (the zeroed output and the kernel, on ids sorted beforehand),
    its plain twin on the card and ``F.embedding``'s backward
    (``embedding_dense_backward`` on the ids and rows in token order;
    never called by the port), beside the bound: g and the sorted ids and
    permutation read once, the whole (V, d) gradient written once."""
    from repro_torch.kernels.mars_gather import mars_gather as mg_mod
    sids, perm, g2 = ops._sort(ids, g)
    flat = ids.reshape(-1).long()
    bytes_moved = g2.numel() * g2.element_size() + 16 * sids.numel() \
        + V * g2.shape[1] * g2.element_size()

    def kern():
        mg_mod.scatter_add_rows(sids, perm, g2, V)

    def plain():
        mg_mod.scatter_add_rows_plain(sids, perm, g2, V)

    def lib():
        torch.ops.aten.embedding_dense_backward(g2, flat, V, -1, False)
    return dict(ms=counted_ms(kern, 20, f"embedding_grad_scatter {case}",
                              "embedding_grad_scatter", 1, tag="[train]"),
                plain_ms=device_ms(plain, 20, f"scatter twin {case}"),
                library_ms=device_ms(lib, 20, f"F.embedding backward {case}"),
                bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", bytes=bytes_moved, ops=0)


def train_f32_check(torch) -> dict:
    """The float32 training loss and every gradient leaf of qwen1.5-0.5b
    at full width (``F32_TRAIN``) on the card, through K5, B5, K2 and
    B2, against the same step on host copies (the plain twins), and with
    remat on against off on the card."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import lm
    from repro_torch.utils.tree import leaf_paths, tree_map
    arch, B, S = F32_TRAIN
    cfg = dataclasses.replace(configs.get(arch), param_dtype="float32",
                              compute_dtype="float32")
    params = lm.init(cfg, torch.Generator("cuda").manual_seed(0))
    batch = next(TokenStream(DataConfig(vocab=cfg.vocab, seq_len=S,
                                        global_batch=B)))

    def grads(p, device, remat):
        named = leaf_paths(p)
        for _, t in named:
            t.requires_grad_(True)
        tokens, labels = (torch.from_numpy(batch[k]).to(device)
                          for k in ("tokens", "labels"))
        loss, _ = lm.loss_fn(p, cfg, tokens, labels, remat=remat)
        gs = torch.autograd.grad(loss, [t for _, t in named])
        return float(loss.detach()), {n: g for (n, _), g in zip(named,
                                                              gs)}

    counters = kernel_counters()
    reset_counts(counters)
    loss_c, g_c = grads(params, "cuda", False)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    loss_r, g_r = grads(params, "cuda", True)
    host = tree_map(lambda t: t.detach().cpu(), params)
    del params
    loss_h, g_h = grads(host, "cpu", False)
    worst = {"host": (0.0, ""), "remat": (0.0, "")}
    for name, want in g_h.items():
        scale = float(want.abs().max()) or 1.0
        for tag, other in (("host", g_c[name].cpu()),
                           ("remat", g_r[name].cpu())):
            ref = want if tag == "host" else g_c[name].cpu()
            r = float((other - ref).abs().max()) / scale
            if r > worst[tag][0]:
                worst[tag] = (r, name)
    bitwise = all(torch.equal(g_r[n], g_c[n]) for n in g_c)
    loss_rel = abs(loss_c - loss_h) / abs(loss_h)
    ok = loss_rel <= F32_LOSS_RTOL \
        and abs(loss_r - loss_c) <= F32_LOSS_RTOL * abs(loss_c) \
        and worst["host"][0] <= F32_GRAD_TOL \
        and worst["remat"][0] <= F32_GRAD_TOL \
        and launches["flash_attention_bwd"] > 0 \
        and launches["embedding_grad_scatter"] > 0
    print(f"[train] float32 step, {arch} at full width, batch {B}x{S}: loss "
          f"card {loss_c:.6f} / host {loss_h:.6f} (relative {loss_rel:.2e}, "
          f"tol {F32_LOSS_RTOL}); {len(g_h)} gradient leaves, largest "
          f"|card - host| / max|host| {worst['host'][0]:.2e} "
          f"({worst['host'][1]}); remat on vs off: loss {loss_r:.6f}, "
          f"largest {worst['remat'][0]:.2e} ({worst['remat'][1]}), "
          f"bitwise {bitwise} (tol {F32_GRAD_TOL}); card launches "
          + ", ".join(f"{k} {launches[k]}" for k in TRAIN_KERNELS)
          + f" {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"float32 training step on the card disagrees "
                             f"with the host: loss {loss_c} vs {loss_h}, "
                             f"{worst}, launches {launches}")
    return dict(loss_card=loss_c, loss_host=loss_h, loss_remat=loss_r,
                worst_host=worst["host"], worst_remat=worst["remat"],
                remat_bitwise=bitwise, launches=launches)


TRAIN_PATH = "train qwen1_5_0_5b"          # the slice's main path
# the training path's backward kernels: (name, source, the reference
# function each takes the place of -- no Pallas kernel: the JAX trainer
# differentiates plain layers.sdpa and calls the jnp
# embedding_grad_scatter -- the timing record and case of its row)
TRAIN_KERNELS_ROWS = (
    ("flash_attention_bwd", "flash_attention_bwd.cu",
     "src/repro/models/layers.py:199", "b5_timing", "qwen/bfloat16"),
    ("embedding_grad_scatter", "embedding_grad_scatter.cu",
     "src/repro/kernels/mars_gather/ops.py:50", "b2_timing",
     "qwen/zipf/bfloat16"))


def train_kernel_rows(launches: dict, record: dict, b5_err: float) -> list:
    """The ``{"kernels": [...]}`` rows of B5 and B2: launches on the
    training main path (``TRAIN_PATH``), their largest error against the
    twin (B2's on host copies, which it must equal bitwise), timed at
    qwen1.5-0.5b's training shapes in bf16 beside the library call."""
    errs = {"flash_attention_bwd": b5_err,
            "embedding_grad_scatter": max(r["host_err"]
                                          for r in record["b2_cases"])}
    rows = []
    for name, source, replaces, timing, case in TRAIN_KERNELS_ROWS:
        t = record[timing][case]
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
            replaces=replaces, launches=launches[TRAIN_PATH][name],
            launches_by_path={p: n[name] for p, n in launches.items()},
            max_abs_err=errs[name], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], case=case))
    return rows


class _Killed(Exception):
    """Stops a training run after a step, as a lost host would."""


# the four kernels of the training path, as ``kernel_counters`` names them
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "gather_rows",
                 "embedding_grad_scatter")


def train_launches_wanted(cfg, steps: int, counters: dict) -> dict:
    """Launches of a training run of ``steps`` steps with remat off: K5
    once per attention a step (an encoder-decoder model's encoder,
    decoder and cross-attention layers), B5 ``BWD_LAUNCHES`` times as
    often, K2 and B2 once a step (a table of at least 2**22 elements)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        BWD_LAUNCHES
    attn = cfg.enc_layers + unwindowed_layers(cfg) \
        + (cfg.n_layers if cfg.family == "encdec" else 0)
    table = steps if cfg.vocab * cfg.d_model >= 1 << 22 else 0
    want = {k: 0 for k in counters}
    want.update(flash_attention=attn * steps,
                flash_attention_bwd=attn * BWD_LAUNCHES * steps,
                gather_rows=table, embedding_grad_scatter=table)
    return want


def train_run(torch, arch: str, steps: int, interval: int, kill_at: int,
              flags=()):
    """``launch.train`` at full width in bf16 (batch and sequence
    ``TRAIN_TOKENS``, a checkpoint every ``interval`` steps) with every
    count set to 0 just before it: finite losses, the last below the
    first, the launches of ``train_launches_wanted``; then the same run
    killed after step ``kill_at - 1`` and resumed with ``--resume`` must
    end at the uninterrupted run's last loss (``TRAIN_RESUME_RTOL``).
    Returns the record and the launches."""
    import math
    import shutil
    from repro_torch.ft.manager import RunSupervisor
    from repro_torch.launch import train
    B, S = TRAIN_TOKENS
    work = ROOT / "build" / "train" / arch
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--ckpt-interval", str(interval),
            "--log-every", "5", "--device", "cuda", *flags]
    name = f"train {arch}"
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    full = train.run(argv + ["--workdir", str(work / "full")])
    torch.cuda.synchronize()
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    cfg, losses = full["cfg"], full["losses"]
    shutil.rmtree(work / "full", ignore_errors=True)
    free_device(torch, name)
    want = train_launches_wanted(cfg, steps, counters)
    step_ms = statistics.median(full["step_s"][1:]) * 1e3
    print(f"[{name}] {steps} steps, batch {B}x{S}, bf16: loss {losses[0]:.4f}"
          f" -> {losses[-1]:.4f}; median step {step_ms:.1f} ms (first "
          f"{full['step_s'][0] * 1e3:.0f} ms), {B * S / step_ms * 1e3:.0f} "
          f"tokens/s; peak allocated {peak / 2**30:.2f} GiB; launches "
          + ", ".join(f"{k} {launches[k]} (want {want[k]})"
                      for k in counters))
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses not finite or not falling: "
                             f"{losses}")
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} on the "
                             f"main path, want {want}")

    after_step = RunSupervisor.after_step

    def killing(self, step, dt):
        events = after_step(self, step, dt)
        if step == kill_at - 1:
            raise _Killed(step)
        return events
    RunSupervisor.after_step = killing
    try:
        train.run(argv + ["--workdir", str(work / "killed")])
        raise AssertionError(f"{name}: the run was not killed")
    except _Killed:
        pass
    finally:
        RunSupervisor.after_step = after_step
    free_device(torch, f"{name} killed at {kill_at}")
    resumed = train.run(argv + ["--workdir", str(work / "killed"),
                                "--resume"])
    shutil.rmtree(work, ignore_errors=True)
    free_device(torch, f"{name} resumed")
    last, want_last = resumed["losses"][-1], losses[-1]
    rel = abs(last - want_last) / abs(want_last)
    print(f"[{name}] killed after step {kill_at - 1}, resumed from step "
          f"{resumed['start_step']}: last loss {last:.6f} against "
          f"{want_last:.6f} uninterrupted (relative {rel:.2e}, tol "
          f"{TRAIN_RESUME_RTOL})")
    if rel > TRAIN_RESUME_RTOL or not 0 < resumed["start_step"] < kill_at:
        raise AssertionError(f"{name}: resumed run ends at {last}, "
                             f"uninterrupted at {want_last}")
    return dict(losses=losses, step_ms=step_ms, tokens_per_s=B * S
                / step_ms * 1e3, peak_bytes=peak, first_step_ms=full[
                    "step_s"][0] * 1e3, resumed_from=resumed["start_step"],
                resumed_losses=resumed["losses"], resume_rel=rel), launches


def profile_train(torch, arch: str, flags=()) -> dict:
    """One warm training step (the third of four, bf16, batch and
    sequence ``TRAIN_TOKENS``) under ``torch.profiler``: its wall, the
    device time by kernel and kind, and the busy share."""
    import shutil
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    B, S = TRAIN_TOKENS
    work = ROOT / "build" / "train" / f"{arch}_profile"
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    make, walls = train.make_train_step, []

    def make_profiled(*a, **kw):
        step, calls = make(*a, **kw), []

        def profiled(*args):
            calls.append(1)
            if len(calls) != 3:
                return step(*args)
            torch.cuda.synchronize()
            prof.start()
            t0 = time.perf_counter()
            try:
                out = step(*args)
                torch.cuda.synchronize()
                return out
            finally:
                walls.append(time.perf_counter() - t0)
                prof.stop()
        return profiled
    train.make_train_step = make_profiled
    try:
        train.run(["--arch", arch, "--steps", "4", "--batch", str(B),
                   "--seq", str(S), "--ckpt-interval", "1000",
                   "--log-every", "100", "--device", "cuda",
                   "--workdir", str(work), *flags])
    finally:
        train.make_train_step = make
        shutil.rmtree(work, ignore_errors=True)
    out = profile_summary(prof, walls[0])
    tag = f"[profile train {arch}]"
    print(f"{tag} one warm step under torch.profiler: wall "
          f"{out['wall_s'] * 1e3:.1f} ms, device kernel time "
          f"{out['device_ms']:.1f} ms (busy share {out['busy_share']:.3f}); "
          f"port kernel launches " + ", ".join(
              f"{k} {v}" for k, v in out["kernel_calls"].items() if v))
    print(f"{tag}   device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(out["by_kind_ms"].items())))
    for row in out["top"]:
        print(f"{tag}   {row['ms']:9.3f} ms {row['calls']:6d}x "
              f"{row['name'][:90]}")
    print(f"{tag} host self time of profiled ops {out['host_ms']:.1f} ms")
    return out


def train_refusals() -> list:
    """``launch.train`` on CUDA refuses every config of
    ``TRAIN_REFUSED`` before it builds anything."""
    from repro_torch.launch import train
    out = []
    for arch in TRAIN_REFUSED:
        try:
            train.run(["--arch", arch, "--steps", "1", "--device", "cuda"])
        except NotImplementedError as e:
            print(f"[train] {arch} refused on CUDA: {e}")
            out.append(arch)
            continue
        raise AssertionError(f"launch.train trained {arch} on CUDA")
    return out


def kernel_grad_refusals(torch) -> list:
    """K3's and K4's wrappers, called on the card with an input that
    needs a gradient, raise without launching (they have no backward
    kernel); under ``torch.no_grad()`` the same call launches."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as k4
    from repro_torch.kernels.ssd_scan import ssd_scan as k3

    def args_k3():
        x = torch.randn(1, 16, 2, 64, device="cuda")
        b, c = (torch.randn(1, 16, 16, device="cuda") for _ in range(2))
        dt = torch.rand(1, 16, 2, device="cuda")
        return (x.requires_grad_(), b, c, -dt, dt), {"chunk": 16}

    def args_k4():
        x = torch.randn(32, 64, device="cuda")
        w = torch.randn(2, 64, 64, device="cuda").requires_grad_()
        return (x, w, torch.tensor([0, 1], dtype=torch.int32,
                                   device="cuda")), {"bm": 16}

    out = []
    for fn, make in ((k3.ssd_scan, args_k3), (k4.grouped_matmul, args_k4)):
        name = fn.__name__
        args, kw = make()
        before = fn.launches
        try:
            fn(*args, **kw)
        except NotImplementedError as e:
            assert fn.launches == before, f"{name} launched, then refused"
            print(f"[train] {name} refused a gradient on CUDA: {e}")
        else:
            raise AssertionError(f"{name} ran on CUDA outside autograd")
        with torch.no_grad():
            fn(*args, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, f"{name} did not launch"
        fn.launches = before
        out.append(name)
    return out


def train_kernel_phase(torch, F, gen) -> tuple:
    """The train phase's kernel part, run beside the other kernel phases
    (before the serve runs' long profiles): B5 and B2 against their
    twins, each timed.  Returns (record, B5's largest error)."""
    b5_results, b5_err, b5_timing = b5_phase(torch, F, gen)
    for case, t in b5_timing.items():
        print(f"[train] flash_attention_bwd {case}: device ms per call: "
              f"kernel {t['ms']:.4f}, bound {t['bound_ms']:.5f} "
              f"({t['bound_by']}; {t['bytes']} B, {t['ops']} ops), plain "
              f"twin {t['plain_ms']:.4f}, SDPA backward {t['library_ms']:.4f}"
              f"; K5 forward at this shape {t['fwd_ms']:.4f} writing lse, "
              f"{t['fwd_nolse_ms']:.4f} without")
    free_device(torch, "B5 cases")
    b2_results, b2_timing = b2_phase(torch, gen)
    for case, t in b2_timing.items():
        print(f"[train] embedding_grad_scatter {case}: device ms per call: "
              f"kernel (with its zeroed output) {t['ms']:.4f}, bound "
              f"{t['bound_ms']:.5f} (bytes; {t['bytes']} B), plain twin "
              f"{t['plain_ms']:.4f}, F.embedding backward "
              f"{t['library_ms']:.4f}")
    free_device(torch, "B2 cases")
    return dict(b5_cases=b5_results, b5_timing=b5_timing,
                b2_cases=b2_results, b2_timing=b2_timing), b5_err


def train_phase(torch) -> tuple:
    """The train phase's runs: the float32 step at full width, the
    refusals, the bf16 training runs (launch counts, resume) and a
    profiled step of each.  Returns (record, launches by run)."""
    f32 = train_f32_check(torch)
    free_device(torch, "float32 training step")
    record = dict(f32=f32, refused=train_refusals(),
                  refused_grad=kernel_grad_refusals(torch), runs={})
    launches = {}
    for arch, steps, interval, kill_at, flags in TRAIN_RUNS:
        record["runs"][arch], launches[f"train {arch}"] = train_run(
            torch, arch, steps, interval, kill_at, flags)
        record["runs"][arch]["profile"] = profile_train(torch, arch, flags)
        free_device(torch, f"profiling train {arch}")
    return record, launches


# the port's kernels as their device-side names show in a profile
KERNEL_NAMES = {"paged_attention": "paged_attention_split_kernel",
                "paged_attention_merge": "paged_attention_merge_kernel",
                "ssd_scan": "ssd_scan_chunk_kernel",
                "ssd_scan_passes": "ssd_scan_pass_kernel",
                "gather_rows": "gather_rows_kernel",
                "grouped_matmul": "grouped_mm_",
                "flash_attention": "flash_attn_",
                "mars_engine": "mars_engine_kernel",
                "dram_channel": "dram_channel_kernel",
                "flash_attention_bwd": "flash_bwd_",
                "embedding_grad_scatter": "embedding_grad_scatter_kernel"}


def print_profile(arch: str, prof: dict) -> None:
    tag = f"[profile {arch}]"
    print(f"{tag} warm serve: engine wall {prof['warm_engine_wall_s']:.3f}"
          f"s for {prof['warm_decode_tokens']} decode tokens "
          f"({prof['warm_decode_tokens'] / prof['warm_engine_wall_s']:.1f} "
          f"tokens/s, {prof['warm_decode_steps']} decode steps)")
    print(f"{tag} warm serve, engine run under torch.profiler: wall "
          f"{prof['wall_s']:.3f}s, device kernel time "
          f"{prof['device_ms']:.1f} ms (busy share "
          f"{prof['busy_share']:.3f}); port kernel launches "
          + ", ".join(f"{k} {v}" for k, v in prof["kernel_calls"].items()))
    print(f"{tag}   device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(prof["by_kind_ms"].items())))
    for row in prof["top"]:
        print(f"{tag}   {row['ms']:9.3f} ms {row['calls']:6d}x "
              f"{row['name'][:90]}")
    print(f"{tag} host self time of profiled ops {prof['host_ms']:.1f} ms; "
          f"longest:")
    for row in prof["host_top"]:
        print(f"{tag}   {row['ms']:9.3f} ms {row['calls']:6d}x "
              f"{row['name'][:90]}")


PHASES = ("k1", "k3", "k2", "k4", "k5", "sim", "serve", "dense", "train")
# what a serve run returns beside its stats: not written to the record
NOT_STATS = ("finished", "cfg", "params", "prompts", "max_new",
             "backend", "obs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                         + " (default: all; only a run of all of them "
                           "prints the result lines)")
    ap.add_argument("--runs", default="",
                    help="serve only the runs whose name contains one of "
                         "these comma-separated strings (prints no result)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    runs = [r for r in RUNS if not args.runs or any(
        k in run_name(*r) for k in args.runs.split(","))]
    dense_runs = [r for r in DENSE_RUNS if not args.runs or any(
        k in run_name(*r) for k in args.runs.split(","))]
    if not phases <= set(PHASES):
        return fail(f"unknown phases {sorted(phases - set(PHASES))}")
    try:
        import torch
        import torch.nn.functional as F
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: no GPU to run on")
    try:
        from repro_torch.kernels import build
        from repro_torch.launch import serve
    except ImportError as e:
        return fail(f"cannot import the port ({e}); run from a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    t_start = time.perf_counter()

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel source(s) in {build_s:.1f}s "
          f"(nvcc sm_90a, one process each, started together)")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")

    # -- kernels vs plain twins ----------------------------------------------
    gen = torch.Generator("cuda").manual_seed(0)
    record = dict(build_s=build_s)
    warm_profiler(torch)
    if "k1" in phases:
        results, max_err, merge_err, timed = kernel_phase(torch, gen)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=gen.device)
        timing = {f"{name}/{dt}": time_case(torch, F, ops, f"{name}/{dt}",
                                            dt, flush)
                  for (name, dt), ops in timed.items()}
        del timed, flush
        for case, t in timing.items():
            print(f"[kernel] paged_attention {case}: device ms per call: "
                  f"split + merge {t['ms']:.4f} (split "
                  f"{ms_txt(t['split_ms'])}, merge {ms_txt(t['merge_ms'])}; "
                  f"{t['n_split']} ranges), bound "
                  f"{t['bound_ms']:.5f} ({t['bound_by']}; {t['bytes']} B, "
                  f"{t['ops']} ops, {t['valid_positions']} valid positions; "
                  f"{t['bound_ms'] / t['ms']:.3f} of it reached), plain twin "
                  f"{t['plain_ms']:.4f}, SDPA over pre-gathered keys (gather "
                  f"excluded) {t['library_ms']:.4f}; after an L2 flush: "
                  f"{t['cold_ms']:.4f} / SDPA {t['cold_library_ms']:.4f}; "
                  f"event ms per call with host launch: {t['event_ms']:.4f} / "
                  f"{t['plain_event_ms']:.4f} / {t['library_event_ms']:.4f}")
            print(f"[kernel] decode_attend {case}: device ms per call "
                  f"{t['decode_ms']:.4f} (merge pass "
                  f"{ms_txt(t['decode_merge_ms'])}"
                  f", bound {t['merge_bound_ms']:.5f}, plain merge "
                  f"{t['merge_plain_ms']:.4f}); event ms per call with host "
                  f"launch {t['decode_event_ms']:.4f}")
        record.update(cases=results, timing=timing,
                      kv_fp8=kv_fp8_check(torch))
        free_device(torch, "K1 phase")
    if "k3" in phases:
        ssd_results, ssd_err, ssd_timing = ssd_phase(torch, F, gen)
        for case, t in ssd_timing.items():
            print(f"[kernel] ssd_scan {case}: device ms per call: kernel "
                  f"{t['ms']:.4f}, bound {t['bound_ms']:.5f} "
                  f"({t['bound_by']}; {t['bytes']} B, {t['ops']} ops), "
                  f"plain twin {t['plain_ms']:.4f}, no PyTorch library call "
                  f"computes the scan; event ms per call with host launch: "
                  f"{t['event_ms']:.4f} / {t['plain_event_ms']:.4f}")
        record.update(ssd_cases=ssd_results, ssd_timing=ssd_timing)
    if "k2" in phases:
        gather_results, gather_timing = gather_phase(torch, F, gen)
        for case, t in gather_timing.items():
            print(f"[kernel] gather_rows {case} ids: device ms per call, "
                  f"cold L2: kernel {t['ms']:.5f}, bound {t['bound_ms']:.5f} "
                  f"(bytes; {t['bytes']} B), plain twin {t['plain_ms']:.5f}, "
                  f"F.embedding {t['library_ms']:.5f}; warm L2: "
                  f"{t['warm_ms']:.5f} / {t['warm_plain_ms']:.5f} / "
                  f"{t['warm_library_ms']:.5f}; event ms per call with host "
                  f"launch: {t['event_ms']:.4f} / {t['plain_event_ms']:.4f} "
                  f"/ {t['library_event_ms']:.4f}")
        record.update(gather_cases=gather_results,
                      gather_timing=gather_timing)
        free_device(torch, "K2 phase")
    if "k4" in phases:
        k4_results, k4_err, k4_timing = k4_phase(torch, gen)
        for case, t in k4_timing.items():
            print(f"[kernel] grouped_matmul {case}: device ms per call, "
                  f"cold L2: kernel {t['ms']:.4f}, bound {t['bound_ms']:.5f} "
                  f"({t['bound_by']}; {t['bytes']} B, {t['ops']} ops), "
                  f"plain twin {t['plain_ms']:.4f}, {t['library']} "
                  f"{t['library_ms']:.4f}; warm L2: {t['warm_ms']:.4f} / "
                  f"{t['warm_plain_ms']:.4f} / {t['warm_library_ms']:.4f}")
        record.update(k4_cases=k4_results, k4_timing=k4_timing)
        free_device(torch, "K4 phase")
    if "k5" in phases:
        k5_results, k5_err, k5_timing = k5_phase(torch, F, gen)
        for case, t in k5_timing.items():
            print(f"[kernel] flash_attention {case}: device ms per call: "
                  f"kernel {t['ms']:.4f}, bound {t['bound_ms']:.5f} "
                  f"({t['bound_by']}; {t['bytes']} B, {t['ops']} ops), "
                  f"plain twin {t['plain_ms']:.4f}, SDPA "
                  f"{t['library_ms']:.4f}; event ms per call with host "
                  f"launch: {t['event_ms']:.4f} / {t['plain_event_ms']:.4f} "
                  f"/ {t['library_event_ms']:.4f}")
        record.update(k5_cases=k5_results, k5_timing=k5_timing)
        free_device(torch, "K5 phase")
    if "train" in phases:
        t0 = time.perf_counter()
        train_record, b5_err = train_kernel_phase(torch, F, gen)
        record.update(train_kernels_s=time.perf_counter() - t0)
    if "sim" in phases:
        t0 = time.perf_counter()
        sim_record, sim_timing, sim_launches = sim_phase(torch)
        record.update(sim=sim_record, sim_timing=sim_timing,
                      sim_s=time.perf_counter() - t0)
        print(f"[time] sim phase {record['sim_s']:.1f}s")
    kernels_s = time.perf_counter() - t_start

    # -- serve at full width, then profile it warm ---------------------------
    served, launches, profiles, failed = {}, {}, {}, []
    if "sim" in phases:
        launches[SIM_PATH] = sim_launches
    run_s = {}                    # seconds of each run: checked, profiled

    def timed_run(name, t0, t1):
        run_s[name] = [t1 - t0, time.perf_counter() - t1]
        print(f"[time] {name}: checked run {run_s[name][0]:.1f}s, warm and "
              f"profiled runs {run_s[name][1]:.1f}s")
    for arch, flags in runs if "serve" in phases else ():
        name = run_name(arch, flags)
        t0 = time.perf_counter()
        try:
            out, launches[name] = serve_phase(torch, serve, arch, flags)
        except AssertionError as e:       # go on: later runs still report
            print(f"[serve {name}] FAILED: {e}")
            failed.append(name)
            free_device(torch, name)
            continue
        served[name] = {k: v for k, v in out.items() if k not in NOT_STATS}
        del out
        free_device(torch, name)
        t1 = time.perf_counter()
        if not UNPROFILED & set(flags) and name not in UNPROFILED_RUNS:
            profiles[name] = profile_serve(torch, serve,
                                           serve_args(arch, flags))
            print_profile(name, profiles[name])
            free_device(torch, f"profiling {name}")
        timed_run(name, t0, t1)
    if "serve" in phases and (not args.runs or any(
            k in TIER_FP8 for k in args.runs.split(","))):
        t0 = time.perf_counter()
        try:
            served[TIER_FP8] = tier_fp8_check(torch, serve)
        except AssertionError as e:
            print(f"[serve {TIER_FP8}] FAILED: {e}")
            failed.append(TIER_FP8)
        free_device(torch, TIER_FP8)
        timed_run(TIER_FP8, t0, time.perf_counter())
    if "serve" in phases and (not args.runs or any(
            k in OVERHEAD_RUN for k in args.runs.split(","))):
        t0 = time.perf_counter()
        served[OVERHEAD_RUN] = metrics_overhead(torch, serve)
        timed_run(OVERHEAD_RUN, t0, time.perf_counter())
    for arch, flags in dense_runs if "dense" in phases else ():
        name = run_name(arch, flags)
        t0 = time.perf_counter()
        try:
            served[name], launches[name] = dense_phase(torch, serve, arch,
                                                       flags)
        except AssertionError as e:       # go on: later runs still report
            print(f"[dense {name}] FAILED: {e}")
            failed.append(name)
            free_device(torch, name)
            continue
        free_device(torch, name)
        t1 = time.perf_counter()
        if not UNPROFILED & set(flags):
            profiles[name] = profile_dense(torch, serve,
                                           dense_args(arch, flags))
            print_profile(name, profiles[name])
            free_device(torch, f"profiling {name}")
        timed_run(name, t0, t1)
    if "train" in phases:
        t0 = time.perf_counter()
        runs_record, train_launches = train_phase(torch)
        train_record.update(runs_record)
        launches.update(train_launches)
        record.update(train=train_record,
                      train_s=time.perf_counter() - t0)
        print(f"[time] train phase {record['train_s']:.1f}s")
    total_s = time.perf_counter() - t_start
    print(f"[time] build {build_s:.1f}s, build + kernel phases "
          f"{kernels_s:.1f}s, whole run {total_s:.1f}s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    record.update(device=smi, kernels_s=kernels_s, total_s=total_s,
                  run_s=run_s,
                  serve=served, launches=launches, profile=profiles)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    if failed:
        return fail(f"serve runs failed: {failed}")
    if phases != set(PHASES) or runs != list(RUNS) \
            or dense_runs != list(DENSE_RUNS):
        print(f"chip_smoke: ran phases {sorted(phases)} only; no result")
        return 0

    def row(name, source, replaces, path, err, t, **over):
        r = dict(name=name, route="cuda",
                 source=f"src/repro_torch/csrc/{source}",
                 replaces=f"src/repro/kernels/{replaces}",
                 launches=launches[path][name],
                 launches_by_path={p: n[name] for p, n in launches.items()},
                 max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                 bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                 library_ms=t["library_ms"])
        r.update(over)
        return r
    arctic = run_name("arctic_480b", ARCTIC)
    k1 = timing["arctic/bfloat16"]
    kernels = [
        row("paged_attention", "paged_attention.cu",
            "paged_attention/paged_attention.py:57", arctic, max_err, k1),
        # K1's merge pass, which folds in the in-flight token (the merge
        # step of the reference's decode_attend): its time within a
        # decode_attend call, against merge_partials_plain on the same
        # partials; no single PyTorch call computes it
        row("paged_attention_merge", "paged_attention.cu",
            "paged_attention/paged_attention.py:204", arctic, merge_err, k1,
            ms=k1["decode_merge_ms"], plain_ms=k1["merge_plain_ms"],
            bound_ms=k1["merge_bound_ms"], bound_by="bytes",
            library_ms=None),
        row("ssd_scan", "ssd_scan.cu", "ssd_scan/ssd_scan.py:21",
            "hymba_1_5b", ssd_err, ssd_timing["long/bfloat16"]),
        row("gather_rows", "mars_gather.cu", "mars_gather/mars_gather.py:25",
            arctic, 0.0, gather_timing[f"arctic/{GATHER_IDS[1]}"]),
        row("grouped_matmul", "moe_dispatch.cu",
            "moe_dispatch/moe_dispatch.py:29", arctic, k4_err,
            k4_timing["arctic_decode_w_in/bfloat16"]),
        row("flash_attention", "flash_attention.cu",
            "flash_attention/flash_attention.py:27", "whisper_base", k5_err,
            k5_timing["whisper_encoder/bfloat16"]),
    ] + sim_kernel_rows(launches, sim_timing) \
        + train_kernel_rows(launches, train_record, b5_err)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
