"""Time B4's dw kernel under other cuts of the work than ``bwd_plan``'s,
at ``chip_smoke.py``'s B4 cases, on one H100.

    python3 tools/b4_split_sweep.py [--cases skew_half,smoke_w_in]

For each case and dtype it times dw (after an L2 flush, as chip_smoke's
b4 phase does) under the plan, without the row split, with slabs of a
given number of rows and, for bf16, at walks of 1 and 4; each variant is
launched through the kernel's C entry point with its own partials, held
to the plan's dw (``B4_TOL``) and to itself on a second call (bitwise).
It reads the cost of the row split (``expert_slabs``) and of the walk
that ``bwd_plan`` picks from shapes alone.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CASES = ("skew_half", "arctic_skew_last", "arctic_w_in", "smoke_w_in",
         "smoke_w_out", "empty_experts")
SLAB_ROWS = (64, 256, 1024, 4096)


def variants(k4, plan, M: int, K: int, N: int, bm: int) -> list:
    """(label, plan): the plan, no split, slabs of ``SLAB_ROWS`` rows (as
    many slots as ``MAX_SPLIT_BYTES`` hold), and the other walk (bf16)."""
    t = k4.MMA_TILE if plan.path == "mma" else k4.CORES_TILE
    room = k4.MAX_SPLIT_BYTES // (-(-K // t) * -(-N // t) * t * t * 4)
    out = [("plan", plan),
           ("no split", plan._replace(slots=0, max_split=1))]
    for rows in SLAB_ROWS:
        tiles = max(1, rows // bm)
        slots = min(room, M // bm // tiles)
        if slots >= 2 and tiles != plan.split_tiles:
            out.append((f"slabs of {rows} rows", plan._replace(
                split_tiles=tiles, slots=slots,
                max_split=min(k4.MAX_ROW_SPLIT, slots))))
    if plan.path == "mma" and -(-N // t) > 1:
        walk = 1 if plan.walk > 1 else min(-(-N // t), k4.DW_WALK)
        out.append((f"walk {walk}, no split", plan._replace(
            walk=walk, slots=0, max_split=1)))
        if plan.slots >= 2:
            out.append((f"walk {walk}", plan._replace(walk=walk)))
    return out


def dw_launcher(torch, k4, c, plan):
    """A function that launches B4's dw kernel under ``plan`` on case
    ``c`` and returns dw; its partials and arrival counters are its own."""
    x, w, dout, tg, bm, n = (c[k] for k in ("x", "w", "dout", "tg", "bm",
                                             "n_used"))
    M, K = x.shape
    G, _, N = w.shape
    lib = k4._bwd_library()
    part = counters = None
    if plan.slots >= 2:
        t = k4.MMA_TILE if plan.path == "mma" else k4.CORES_TILE
        tiles = plan.slots * -(-K // t) * -(-N // t)
        part = torch.empty(tiles * t * t, dtype=torch.float32,
                           device=x.device)
        counters = torch.zeros(tiles, dtype=torch.int32, device=x.device)

    def run():
        dw = torch.empty_like(w)
        rc = lib.mars_grouped_matmul_bwd_dw(
            k4._DTYPE_CODES[x.dtype], k4.PATH_CODES_BWD[plan.path],
            x.data_ptr(), dout.data_ptr(), tg.data_ptr(),
            None if n is None else n.data_ptr(), dw.data_ptr(), M, K, N, G,
            bm, plan.walk, plan.split_tiles, plan.max_split, plan.slots,
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"dw launch failed: rc={rc} (plan {plan})")
        return dw
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args(argv)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.moe_dispatch import moe_dispatch as k4
    if not torch.cuda.is_available():
        print("no GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    wanted = set(args.cases.split(","))
    ok = True
    for name, kind, spec, dtypes in cs.B4_CASES:
        if name not in wanted:
            continue
        for dtype in dtypes:
            if name == "arctic_w_in" and dtype == "float32":
                continue            # 17.9 GB a dw: two of them do not fit
            c = cs.b4_case(torch, gen, kind, spec, getattr(torch, dtype))
            M, K = c["x"].shape
            G, _, N = c["w"].shape
            plan = k4.bwd_plan(M, K, N, G, c["bm"], c["x"].dtype, sm,
                               K % 8 == 0 and N % 8 == 0)
            ref = None
            for label, p in variants(k4, plan, M, K, N, c["bm"]):
                run = dw_launcher(torch, k4, c, p)
                got, again = run(), run()
                torch.cuda.synchronize()
                same = torch.equal(got, again)
                del again
                if ref is None:
                    ref, err = got, 0.0
                else:
                    err = max(cs.bwd_err(got[g:g + 4], ref[g:g + 4],
                                         cs.B4_TOL[dtype])[1]
                              for g in range(0, G, 4))
                del got
                ms = cs.cold_ms(torch, run, 10, flush)
                ok = ok and same and err <= 1.0
                print(f"[b4 split] {name}/{dtype} {label:22s} walk={p.walk} "
                      f"split_tiles={p.split_tiles} slots={p.slots}: dw "
                      f"{ms:.4f} ms; against the plan's {err:.3f} of tol; "
                      f"two calls {'bitwise equal' if same else 'DIFFER'}",
                      flush=True)
            del ref, c
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
