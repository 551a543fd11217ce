#!/usr/bin/env python3
"""Time K5 (``flash_attention``) and K2 (``gather_rows``) at every case of
``chip_smoke.py`` on one GPU.

    python3 tools/k5_timing.py [--src PATH] [--only k5,k2] [--seed N]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
so two trees can be compared on the same card in one call, one process
each, in turns (A, B, B, A); each tree builds its kernels into its own
``build/``.  K5: every case of ``chip_smoke.K5_CASES`` in bfloat16 and
float32, device ms per call (``chip_smoke.device_ms``: torch.profiler,
retried, never read as 0), beside SDPA on (B, H, S, D) copies made
beforehand and the bound (``chip_smoke.k5_bound``).  K2: every
``GATHER_TABLES`` x ``GATHER_IDS`` case with int32 ids, sorted as
``embedding_gather`` sorts them, device ms of one call after a 256 MB
write that evicts the L2 (``chip_smoke.cold_ms``), beside
``F.embedding`` timed the same way and the bytes bound.  Inputs come from
``--seed``.  Prints one JSON line per case, then one with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--only", default="k5,k2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k5_timing: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs          # case lists and timers; no repro_torch
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_attention import flash_attention as k5
    from repro_torch.kernels.mars_gather import mars_gather as mg
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(args.seed)
    cs.warm_profiler(torch)
    only = set(args.only.split(","))
    if "k5" in only:
        for dtype in ("bfloat16", "float32"):
            for name, B, Sq, Sk, H, D, causal in cs.K5_CASES:
                q, k, v = cs.k5_inputs(torch, gen, B, Sq, Sk, H, D,
                                       getattr(torch, dtype))
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                case = f"{name}/{dtype}"
                ms = cs.device_ms(
                    lambda: k5.flash_attention(q, k, v, causal=causal), 20,
                    f"flash_attention {case}")
                lib = cs.device_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), 20, f"SDPA {case}")
                print(json.dumps(dict(
                    src=args.src, kernel="flash_attention", case=case,
                    ms=ms, library_ms=lib, **cs.k5_bound(q, k, causal,
                                                         dtype))),
                      flush=True)
                del q, k, v, qt, kt, vt
                torch.cuda.empty_cache()
    if "k2" in only:
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        for tname, (V, D, dtypes) in cs.GATHER_TABLES.items():
            for dtype in dtypes:
                table = torch.randn(V, D, generator=gen, device="cuda") \
                    .to(getattr(torch, dtype))
                for n in cs.GATHER_IDS:
                    ids = torch.randint(0, V, (n,), generator=gen,
                                        device="cuda", dtype=torch.int32)
                    sids = ids[torch.argsort(ids >> 2, stable=True)]
                    nbytes = 2 * n * D * table.element_size() + n * 4
                    print(json.dumps(dict(
                        src=args.src, kernel="gather_rows",
                        case=f"{tname}/{n}/{dtype}",
                        ms=cs.cold_ms(torch, lambda: mg.gather_rows(
                            table, sids), 30, flush),
                        library_ms=cs.cold_ms(torch, lambda: F.embedding(
                            sids, table), 30, flush),
                        bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                        bytes=nbytes)), flush=True)
                del table
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(src=args.src, device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
