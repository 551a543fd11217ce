#!/usr/bin/env python3
"""How far a float32 training step lies from float64, on the card and on
the host, over several parameter seeds: the data behind ``chip_smoke``'s
``F32_DRIFT``.

    python3 tools/f32_drift.py                       # on an H100
    python3 tools/f32_drift.py mamba2_370m:0,1,2,3

For each seed it runs ``chip_smoke.train_f32_check`` (batch 2 x 128, the
config at full width, every layer) with the parameters drawn from that
seed, records each gradient leaf's |g - g64| / max|g64| on the card and
for the host's own float32 step, and prints the card / host ratio per
leaf and of the largest gaps.  The check's bound is lifted while it runs,
so every seed is recorded.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*",
                    default=["qwen1_5_0_5b:0", "mamba2_370m:0,1,2,3"],
                    help="config:seeds, e.g. mamba2_370m:0,1")
    args = ap.parse_args(argv)
    plan = [(arch, int(seed)) for run in args.runs
            for arch, seeds in [run.split(":")] for seed in seeds.split(",")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    cs.F32_DRIFT = float("inf")
    init = lm.init
    try:
        for arch, seed in plan:
            lm.init = lambda cfg, gen, _s=seed: init(cfg, gen.manual_seed(_s))
            t0 = time.time()
            gaps = cs.train_f32_check(torch, arch, 2, 128)["gaps"]
            ratio = {n: c / h for n, (c, h) in gaps.items()}
            card = max(c for c, _ in gaps.values())
            host = max(h for _, h in gaps.values())
            order = sorted(ratio.values())
            print(f"[drift] {arch} seed {seed}: per-leaf card/host ratio min "
                  f"{order[0]:.2f} median {order[len(order) // 2]:.2f} max "
                  f"{order[-1]:.2f} ({max(ratio, key=ratio.get)}); largest "
                  f"gap card {card:.2e} host {host:.2e} (ratio "
                  f"{card / host:.2f}); {time.time() - t0:.1f}s", flush=True)
            cs.free_device(torch, f"{arch} seed {seed}")
    finally:
        lm.init = init
    return 0


if __name__ == "__main__":
    sys.exit(main())
