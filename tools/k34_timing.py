#!/usr/bin/env python3
"""Time K4 (``grouped_matmul``) and K3 (``ssd_scan``) at every case of
``chip_smoke.py`` on one GPU.

    python3 tools/k34_timing.py [--src PATH] [--only k4,k3] [--seed N]
                                [--k4-waves 1,2,4] [--k3-plans 8:64,2:32]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
so two trees can be compared on the same card in one call, one process
each, in turns (A, B, B, A); each tree builds its kernels into its own
``build/``.  K4: every ``chip_smoke.K4_ROUTE`` case in bfloat16 (the
routing drawn from ``--seed`` and the case's index, so every tree sees
the same operands), device ms of one call after a 256 MB write that
evicts the L2 (``chip_smoke.cold_ms``), beside ``torch._grouped_mm`` on
the unpadded rows timed the same way and the bound (``chip_smoke.
time_k4``'s bytes and operations).  K3: every ``chip_smoke.SSD_CASES``
entry in bfloat16 and float32, device ms per call (``chip_smoke.
device_ms``: torch.profiler, retried, never read as 0) and each
kernel's share of it, beside the plain twin and the bound
(``chip_smoke.time_ssd``).  ``--k4-waves`` times K4 again with each
``SPLIT_WAVES`` of its split plan, and ``--k3-plans`` K3 with each
forced (heads, P block) pair (the tree's ``split_plan`` must have them).
Prints one JSON line per case, then one with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def k4_cases(torch, cs, k4, args, flush):
    waves = [None] + [int(w) for w in args.k4_waves.split(",") if w]
    for i, (name, T, k, E, K, N) in enumerate(cs.K4_ROUTE):
        gen = torch.Generator("cuda").manual_seed(args.seed * 1000 + i)
        c = cs.k4_route_case(torch, gen, T, k, E, K, N, torch.bfloat16)
        for w in waves:
            if w is not None:
                k4.SPLIT_WAVES = w
                k4.split_plan.cache_clear()
            t = cs.time_k4(torch, k4, c, "bfloat16", flush)
            print(json.dumps(dict(src=args.src, kernel="grouped_matmul",
                                  case=f"{name}/bfloat16", split_waves=w,
                                  used_experts=c["used_groups"], **t)),
                  flush=True)
        del c
        torch.cuda.empty_cache()


def k3_cases(torch, F, cs, ssd, args):
    plans = [None] + [tuple(int(v) for v in p.split(":"))
                      for p in args.k3_plans.split(",") if p]
    auto = getattr(ssd, "split_plan", None)
    for i, (name, B, S, H, P, N, chunk) in enumerate(cs.SSD_CASES):
        for dtype in ("bfloat16", "float32"):
            gen = torch.Generator("cuda").manual_seed(args.seed * 1000 + i)
            ins = cs.ssd_inputs(torch, F, gen, B, S, H, P, N,
                                getattr(torch, dtype))
            for plan in plans:
                if plan is not None:
                    q = min(chunk, S)
                    ssd.split_plan = lambda *a, _p=plan, _n=S // q: \
                        ssd.Plan(_p[0], _p[1], _n)
                case = f"{name}/{dtype}"
                rows = cs.device_profile(
                    lambda: ssd.ssd_scan(*ins, chunk=chunk), 20,
                    f"ssd_scan {case}")
                # the plain twin and the bound once, with the tree's plan
                t = cs.time_ssd(torch, ssd, ins, chunk, dtype) \
                    if plan is None else dict(ms=sum(r["ms"] for r in rows))
                by_kernel = {r["name"][:100]: r["ms"] for r in rows}
                print(json.dumps(dict(
                    src=args.src, kernel="ssd_scan", case=case,
                    plan=plan or (auto(B, S, H, P, N, min(chunk, S), 132)
                                  if auto else None),
                    by_kernel=by_kernel, **t)), flush=True)
                if auto is not None:
                    ssd.split_plan = auto
            del ins
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", default="k4,k3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k4-waves", default="")
    ap.add_argument("--k3-plans", default="")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k34_timing: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs          # case lists and timers; no repro_torch
    sys.path.insert(0, args.src)
    from repro_torch.kernels.moe_dispatch import moe_dispatch as k4
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.warm_profiler(torch)
    only = set(args.only.split(","))
    if "k4" in only:
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        k4_cases(torch, cs, k4, args, flush)
        del flush
    if "k3" in only:
        k3_cases(torch, F, cs, ssd, args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(src=args.src, device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
