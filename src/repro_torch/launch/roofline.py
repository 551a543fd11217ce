"""Roofline table from the port's dry-run JSONL records (counterpart of
``repro/launch/roofline.py``, whose ``load``, ``fmt_row`` and ``main``
it keeps).

``python -m repro_torch.launch.roofline dryrun.jsonl`` prints the
markdown table and the per-cell bottleneck analysis.  The hints name
what moves each bound on an H100.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict


MOVE_HINTS = {
    "compute": "raise tensor-core occupancy: bf16 wgmma tiles, fewer"
               " rematerialized or repeated (per-model-rank) flops",
    "memory": "fuse or cast: traced bytes are unfused upper bounds; keep"
              " activations bf16; more work per HBM pass",
    "collective": "overlap NVLink transfers with compute; gather each layer"
                  " as it runs instead of the whole model at once",
}


def load(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                out.append(json.loads(line))
    # last record per (arch, shape, mesh) wins (reruns append)
    dedup = {}
    for r in out:
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return list(dedup.values())


def fmt_row(r: dict) -> str:
    if r["status"] == "skip":
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"SKIP | {r['reason']} |")
    if r["status"] != "ok":
        return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
                f"ERROR | {r['error'][:60]} |")
    tc, tm, tl = r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]
    dom = r["dominant"]
    frac = r["roofline_fraction"]
    ratio = r["useful_flop_ratio"]
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | {tc:.2e} | "
            f"{tm:.2e} | {tl:.2e} | {dom} (frac {frac:.3f}, "
            f"useful {ratio:.2f}) | {MOVE_HINTS[dom][:58]} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    recs = load(args.jsonl)
    if args.mesh:
        recs = [r for r in recs if r["mesh"] == args.mesh]
    recs.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    print("| arch | shape | mesh | t_compute | t_memory | t_collective |"
          " bottleneck | to move it |")
    print("|---|---|---|---|---|---|---|---|")
    for r in recs:
        print(fmt_row(r))
    ok = [r for r in recs if r["status"] == "ok"]
    if ok:
        print(f"\n{len(ok)} ok / "
              f"{sum(r['status'] == 'skip' for r in recs)} skip / "
              f"{sum(r['status'] == 'error' for r in recs)} error")
        by_dom = defaultdict(int)
        for r in ok:
            by_dom[r["dominant"]] += 1
        print("bottleneck distribution:", dict(by_dom))
        worst = sorted(ok, key=lambda r: r["roofline_fraction"])[:5]
        print("worst roofline fractions:",
              [(r["arch"], r["shape"], round(r["roofline_fraction"], 4))
               for r in worst])
        coll = sorted(ok, key=lambda r: -r["t_collective_s"])[:5]
        print("most collective-bound:",
              [(r["arch"], r["shape"], f"{r['t_collective_s']:.2e}s")
               for r in coll])


if __name__ == "__main__":
    main()
