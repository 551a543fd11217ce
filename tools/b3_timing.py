#!/usr/bin/env python3
"""Time B3, the SSD scan's backward (``ssd_scan_bwd``), against an earlier
version of its kernels, on one GPU, in one process.

    python3 tools/b3_timing.py [--parent REV | --parent-csrc DIR]
                               [--reps 10] [--cases NAME,...]

The earlier B3 (four launches on CUDA cores: U_c, the reverse
pass, the grad kernel, the sum over head groups) is built with ``nvcc``
(the flags of ``repro_torch.kernels.build``) from ``REV``'s
``src/repro_torch/csrc/ssd_scan_bwd.cu`` (``git show``; default 1d02f1e),
or from the copy in ``DIR`` where the checkout has no ``.git``, into the
git-ignored ``build/b3_parent/``, and called through ctypes with its own
C signature and its own head plan (``parent_plan``); the current one
through the port's wrapper.  At every ``chip_smoke.B3_CASES`` case and
dtype, on inputs from ``chip_smoke.ssd_inputs`` (seed 0) and K3's kept
entering states and decays:

  * both versions' gradients against the plain twin on the card, as
    ``chip_smoke.b3_err`` reads them (largest share of ``B3_REL``);
  * device ms a call of each from whole ``torch.profiler`` profiles
    (``chip_smoke.counted_ms``: every launch of the call in the profile,
    kernels named ``ssd_bwd_``), in turns (earlier, current, current,
    earlier), the mean of each pair;
  * each kernel's share of a call (``kernels_ms``, one more profile);
  * ``chip_smoke.b3_bound``: the current route's bound (tensor-core
    passes and bytes) and the f32 CUDA-core bound.

Prints the compiler's register, shared-memory and spill lines for both
builds, one JSON line a case, then one with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = "1d02f1e"
OUT = ROOT / "build" / "b3_parent"


def _pad4(*vs):
    return tuple(-(-v // 4) * 4 for v in vs)


@functools.lru_cache(maxsize=None)
def parent_plan(B, S, H, P, N, q, sm_count) -> int:
    """The earlier ``bwd_plan``: of 1, 2, 4, 8, 16, 32 heads a block (no more
    than H), the fewest waves of one block an SM times a block's
    multiply-adds on CUDA cores."""
    nc = S // q
    q4, n4, p4 = _pad4(q, N, P)
    best = None
    for hg in sorted({min(v, max(H, 1)) for v in (1, 2, 4, 8, 16, 32)}):
        head = 2 * q4 * q4 * p4 + 3 * q4 * p4 * n4 \
            + (q4 * p4 * n4 if nc > 1 else 0)
        cost = -(-(nc * B * -(-H // hg)) // sm_count) \
            * (100_000 + 3 * q4 * q4 * n4 + hg * head)
        if best is None or cost < best[0]:
            best = (cost, hg)
    return best[1]


def parent_parts(P, N) -> int:
    """The earlier ``bwd_pass_parts``: d(decay) partials a (batch, chunk,
    head), one a warp of its pass kernel."""
    v = 4 if (P * N) % 4 == 0 else 1
    return -(-(P * N) // (256 * v)) * 8


def parent_library(rev: str, csrc: str | None):
    """The earlier B3 built and loaded, its C signature declared; returns
    (library, compiler log)."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssd_scan_bwd.cu"
    if csrc:
        src.write_bytes((Path(csrc) / "ssd_scan_bwd.cu").read_bytes())
    else:
        src.write_bytes(subprocess.run(
            ["git", "show", f"{rev}:src/repro_torch/csrc/ssd_scan_bwd.cu"],
            cwd=ROOT, capture_output=True, check=True).stdout)
    lib = OUT / "libssd_scan_bwd_parent.so"
    proc = subprocess.run([build._nvcc(), *build.FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the earlier B3:\n{proc.stdout}"
                           f"{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    fn = dll.mars_ssd_scan_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return dll, proc.stdout + proc.stderr


def parent_bwd(torch, lib, ins, dy, ds, q, saved, sm_count):
    """The earlier B3 on one case: (dx, db, dc, dla, ddt)."""
    x, b, c, la, dt = ins
    Bz, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // q
    dev = x.device
    entering, decay = saved if nc > 1 else (None, None)
    hg = parent_plan(Bz, S, H, P, N, q, sm_count)
    parts = parent_parts(P, N)
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    dla = torch.empty((Bz, S, H), dtype=torch.float32, device=dev)
    ddt = torch.empty_like(dla)
    pdb = torch.empty((-(-H // hg), Bz, S, N), dtype=torch.float32,
                      device=dev)
    pdc = torch.empty_like(pdb)
    gbuf = dd = None
    if nc > 1:
        gbuf = torch.empty((Bz, nc, H, P, N), dtype=torch.float32, device=dev)
        dd = torch.empty((Bz, nc, H, parts), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = lib.mars_ssd_scan_bwd(
        0 if x.dtype == torch.float32 else 1, *(ptr(t) for t in (
            x, b, c, la, dt, dy, ds, entering, decay, gbuf, dd, dx, db, dc,
            dla, ddt, pdb, pdc)), Bz, S, H, P, N, q, hg, parts,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier B3 failed: rc={rc}")
    return dx, db, dc, dla, ddt


def kernel_ms(cs, fn, reps: int, case: str, launches: int) -> dict:
    """Device ms a call of each of B3's kernels (``ssd_bwd_state``,
    ``_grad``, ``_sum``; the earlier version's ``_pass`` too), from one
    whole profile (None if every profile came back short)."""
    rows = cs.counted_rows(fn, reps, case, "ssd_bwd_", launches, tag="[b3]")
    if rows is None:
        return None
    out = {}
    for r in rows:
        m = re.search(r"ssd_bwd_[a-z]+", r["name"])
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + r["ms"]
    return out


def compiler_lines(tag: str, log: str) -> None:
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"[build] {tag}: {ln.strip()[:160]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=PARENT,
                    help="git revision of the earlier kernels")
    ap.add_argument("--parent-csrc", default=None,
                    help="directory holding the earlier ssd_scan_bwd.cu "
                         "(instead of --parent)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default=None,
                    help="comma-separated B3_CASES names (default: all)")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("b3_timing: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_scan as k3
    compiler_lines("current", build.build_all(("ssd_scan",
                                               "ssd_scan_bwd"))["ssd_scan_bwd"])
    lib, log = parent_library(args.parent, args.parent_csrc)
    compiler_lines("parent", log)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.warm_profiler(torch)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = set(args.cases.split(",")) if args.cases else None
    for name, B, S, H, P, N, chunk, dtypes, with_state, shift in \
            cs.B3_CASES:
        if want is not None and name not in want:
            continue
        q = min(chunk, S)
        for dtype in dtypes:
            ins = cs.ssd_inputs(torch, F, gen, B, S, H, P, N,
                                getattr(torch, dtype), shift)
            dy = torch.randn(B, S, H, P, generator=gen, device="cuda")
            ds = torch.randn(B, H, P, N, generator=gen, device="cuda") \
                if with_state else None
            _, _, saved = k3.ssd_scan_with_states(*ins, chunk=chunk)
            fns = {"parent": lambda: parent_bwd(torch, lib, ins, dy, ds, q,
                                                saved, sm),
                   "current": lambda: k3.ssd_scan_bwd(
                       *ins, dy, ds, chunk=chunk, saved=saved)}
            twin = k3.ssd_scan_bwd_plain(*ins, dy, ds, chunk=chunk,
                                         entering=saved[0])
            errs = {}
            for who, fn in fns.items():
                got = fn()
                errs[who] = max(cs.b3_err(g, w, dtype == "bfloat16" and i < 3)
                                [1] for i, (g, w) in enumerate(zip(got, twin)))
                del got
            del twin
            launches = {"parent": 4 if S > q else 2,
                        "current": k3.bwd_launches(S // q)}
            got = {"parent": [], "current": []}
            for who in ("parent", "current", "current", "parent"):
                got[who].append(cs.counted_ms(
                    fns[who], args.reps, f"b3 {who} {name}/{dtype}",
                    "ssd_bwd_", launches[who], tag="[b3]"))
            kernels = {who: kernel_ms(cs, fns[who], args.reps,
                                      f"b3 {who} {name}/{dtype}",
                                      launches[who]) for who in fns}
            bound = cs.b3_bound(B, S, H, P, N, q, dtype, with_state)
            row = dict(case=f"{name}/{dtype}", B=B, S=S, H=H, P=P, N=N, q=q,
                       heads_a_block=dict(
                           parent=parent_plan(B, S, H, P, N, q, sm),
                           current=k3.bwd_plan(B, S, H, P, N, q, sm)),
                       launches=launches,
                       err_over_tol=errs,
                       parent_ms=sum(got["parent"]) / 2,
                       current_ms=sum(got["current"]) / 2,
                       turns_ms=got, kernels_ms=kernels, **bound)
            row["speedup"] = row["parent_ms"] / row["current_ms"]
            row["current_over_bound"] = row["current_ms"] / row["bound_ms"]
            print(json.dumps(row), flush=True)
            del ins, dy, ds, saved
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
