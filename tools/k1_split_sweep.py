#!/usr/bin/env python3
"""Sweep K1's split plan on one GPU: device time of ``paged_attention``
(split + merge passes) at ``chip_smoke.py``'s timed K1 shapes for several
values of ``BLOCKS_PER_SM``, the number of split-pass blocks an SM that
``split_plan`` aims for.

    python3 tools/k1_split_sweep.py [--blocks 1,2,4,8,16,32] [--dtype bfloat16]

Prints one JSON line per (case, value): the plan's range count and span,
the device ms per call of each pass (``torch.profiler``, 50 calls after a
warm-up), and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (name, B, H, Hkv, D, page, L, P, n_pages, lengths, layer, window): the
# timed cases of chip_smoke.py's k1 phase ("long" draws its lengths there;
# here they are fixed, ragged up to 4096 with one empty lane)
CASES = [
    ("serve", 8, 16, 16, 64, 16, 24, 256, 8,
     [5, 17, 33, 60, 77, 90, 111, 127], 7, 0),
    ("long", 8, 16, 16, 64, 16, 2, 2048, 256,
     [3900, 1200, 2700, 0, 4096, 350, 3100, 2222], 1, 0),
    ("hymba", 8, 25, 5, 64, 16, 2, 1100, 128,
     [0, 1, 1023, 1024, 1025, 1500, 2047, 2048], 1, 1024),
    ("arctic", 8, 56, 8, 128, 16, 2, 1100, 128,
     [0, 1, 17, 255, 1024, 1500, 2047, 2048], 1, 0),
    ("kimi", 8, 64, 8, 112, 16, 2, 1100, 128,
     [0, 1, 17, 255, 1024, 1500, 2047, 2048], 1, 0),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", default="1,2,4,8,16,32")
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_split_sweep: no GPU", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels.paged_attention import paged_attention as pa
    gen = torch.Generator("cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    default = pa.BLOCKS_PER_SM
    for (name, B, H, Hkv, D, page, L, P, n_pages, lengths, layer,
         window) in CASES:
        q, kp, vp, _, _, pt, ln = chip_smoke.make_case(
            gen, B=B, H=H, Hkv=Hkv, D=D, page=page, L=L, P=P,
            n_pages=n_pages, lengths=lengths, dtype=dtype)
        for blocks in (int(x) for x in args.blocks.split(",")):
            pa.BLOCKS_PER_SM = blocks
            n, pps = pa.split_plan(n_pages, page, B, Hkv, H // Hkv, sms)
            rows = chip_smoke.device_profile(
                lambda: pa.paged_attention(q, kp, vp, pt, ln, layer=layer,
                                           window=window, return_state=True),
                50, f"{name} blocks/SM {blocks}",
                ("paged_attention_split", "paged_attention_merge"))
            print(json.dumps(dict(
                case=name, dtype=args.dtype, blocks_per_sm=blocks,
                n_split=n, pages_per_split=pps,
                ms=sum(r["ms"] for r in rows),
                split_ms=chip_smoke.rows_ms(rows, "paged_attention_split"),
                merge_ms=chip_smoke.rows_ms(rows, "paged_attention_merge"),
                device=smi)), flush=True)
        pa.BLOCKS_PER_SM = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
