#!/usr/bin/env python3
"""Time K1's ``decode_attend`` per call, host launch included, on one GPU.

    python3 tools/k1_decode_timing.py [--src PATH] [--reps N]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
so two trees can be compared in one process each on the same card: run
them in turns (A, B, B, A).  The case is the serve case of
``chip_smoke.py``'s k1 phase (qwen1.5-0.5b: 8 lanes, 16 heads of 64, one
KV head each, pages of 16, lengths below 128, a 24-layer pool) in
bfloat16, with operands drawn from ``--seed``.  Prints one JSON line: the
median of ``--reps`` CUDA-event timings of one call (the card waits for
the host's enqueue, so the launches count), the mean per call of a loop
of ``--reps`` back-to-back calls on the host clock, the kernel launches a
call makes by name (``torch.profiler``), and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_decode_timing: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    B, H, Hkv, D, page, L, P, n_pages = 8, 16, 16, 64, 16, 24, 256, 8
    bf = torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)
    q, kn, vn = rand(B, H, D), rand(B, Hkv, D), rand(B, Hkv, D)
    kp, vp = rand(L, P, page, Hkv, D), rand(L, P, page, Hkv, D)
    pt = torch.randperm(P, generator=gen, device=dev)[:B * n_pages] \
        .reshape(B, n_pages).to(torch.int32).contiguous()
    ln = torch.randint(1, 8 * 16, (B,), generator=gen, device=dev,
                       dtype=torch.int32)

    def call():
        pa.decode_attend(q, kn, vn, kp, vp, pt, ln, layer=7)
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        call()
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / args.reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    kernels = {e.key[:80]: e.count / 10 for e in prof.key_averages()
               if e.count and "Memcpy" not in e.key}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(src=args.src, event_ms=statistics.median(times),
                          loop_ms=loop_ms, launches_per_call=kernels,
                          n_launches=sum(kernels.values()), device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
