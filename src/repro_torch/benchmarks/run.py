"""Benchmark runner of the paper simulator on the port:
``PYTHONPATH=src python -m repro_torch.benchmarks.run``.

Prints ``name,us_per_call,derived`` CSV under the reference's row names
(``benchmarks/run.py``): Fig 2/7/8 (``paper_figures``), the ablations and
the KV-cache rows that replay traces through ``core.dram.simulate``
(``kvcache_sim``).  ``--device`` picks where the simulator's two scans run
(``cuda``, the default, launches the MARS engine and DRAM channel kernels
and fails without a GPU; ``cpu`` runs their plain twins).

``--smoke`` runs the sections that support it (the KV-cache rows, at the
reference's smoke sizes) and skips the rest.  ``--baseline <path>``
compares the simulated rows (``kvcache/placement/``, ``kvcache/decode/
{gather,kernel}/``, ``kvcache/tier/promote/``) with the snapshot's keys
of those names and exits non-zero on any difference at the printed
precision: they are integers of a model, bit-stable across machines, so
there is no tolerance.  Snapshot keys of other names (wall-clock ratios,
allocator and scheduler rows) are not this runner's and are not read.
``--json <path>`` dumps every emitted row.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import sys

SIMULATED = re.compile(
    r"^kvcache/(placement/|decode/(gather|kernel)/|tier/promote/)")
BASELINE_DEFAULT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), *[os.pardir] * 3,
    "results", "bench_baseline.json")


def parse_value(derived: str):
    """Leading float of a derived string ("3.21GB/s", "42.5%hit")."""
    m = re.match(r"^-?\d+(\.\d+)?", derived)
    return float(m.group(0)) if m else None


def check_baseline(rows, baseline: dict) -> list[str]:
    """Differences between the simulated rows of this run and the
    snapshot's keys of those names, exact at the printed precision; a
    snapshot key this run did not emit is a difference too."""
    current = {r["name"]: parse_value(r["derived"]) for r in rows}
    failures = []
    for key, want in sorted(baseline.items()):
        if not SIMULATED.match(key):
            continue
        got = current.get(key)
        if got is None:
            failures.append(f"{key}: missing from this run (baseline "
                            f"{want})")
        elif got != want:
            failures.append(f"{key}: {got} vs baseline {want}")
    return failures


def sections(device: str):
    """(name, run(emit), smoke-aware) of every section."""
    from repro_torch.benchmarks import ablations, kvcache_sim, paper_figures
    return [(name, functools.partial(mod.run, device=device), smoke)
            for name, mod, smoke in (("paper_figures", paper_figures, False),
                                     ("ablations", ablations, False),
                                     ("kvcache_sim", kvcache_sim, True))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="substring filter on benchmark section name")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced pass; sections without smoke support "
                         "are skipped")
    ap.add_argument("--device", default="cuda",
                    help="where the simulator's scans run: cuda (the "
                         "kernels) or cpu (their plain twins)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also dump the emitted rows as JSON")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="compare the simulated rows with a snapshot "
                         f"(e.g. {os.path.normpath(BASELINE_DEFAULT)}); "
                         "fail on any difference")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    resolve_device(args.device)

    rows: list[dict] = []

    def emit(name: str, us: float, derived: str = "") -> None:
        print(f"{name},{us:.1f},{derived}")
        sys.stdout.flush()
        rows.append({"name": name, "us_per_call": round(us, 1),
                     "derived": derived})

    print("name,us_per_call,derived")
    for name, fn, smoke_aware in sections(args.device):
        if args.only and args.only not in name:
            continue
        if args.smoke:
            if smoke_aware:
                fn(emit, smoke=True)
            continue
        fn(emit)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"smoke": args.smoke, "device": args.device,
                       "rows": rows}, f, indent=2)
        print(f"[bench] wrote {len(rows)} rows to {args.json}",
              file=sys.stderr)
    if args.baseline:
        with open(args.baseline) as f:
            baseline = json.load(f)
        failures = check_baseline(rows, baseline)
        for msg in failures:
            print(f"[bench] DIFFERENT {msg}", file=sys.stderr)
        if failures:
            return 1
        n = sum(1 for k in baseline if SIMULATED.match(k))
        print(f"[bench] baseline check passed ({n} simulated keys equal)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
