#!/usr/bin/env python3
"""Time B4, the grouped matmul's backward (``grouped_matmul_bwd``), against
an earlier version of its kernels, on one GPU, in one process.

    python3 tools/b4_timing.py [--parent REV | --parent-csrc DIR]
                               [--reps 10] [--cases NAME,...]

The earlier B4 (dx and dw on ``mma.sync`` fed by ``cp.async``, dw's row
split decided on the device) is built with ``nvcc`` (the flags of
``repro_torch.kernels.build``) from ``REV``'s
``src/repro_torch/csrc/moe_dispatch_bwd.cu`` (``git show``; default
f1e2ef4), or from the copy in ``DIR`` where the checkout has no ``.git``,
into the git-ignored ``build/b4_parent/``, and called through ctypes with
its own C signature and its own plan (``parent_plan``); the current one
through the port's wrapper.  At every bfloat16 ``chip_smoke.B4_CASES``
case (operands from ``chip_smoke.b4_case``, seed 0; ``write_only`` is
arctic's w_in routing with ``n_tiles`` 0, which times each tree's store
path alone):

  * the current dx and dw against the earlier ones (largest share of
    twice ``chip_smoke.B4_TOL``: each may lie one bf16 spacing from the
    exact sum);
  * dx and dw apart, device ms a call with a cold L2
    (``chip_smoke.cold_ms``), in turns (earlier, current, current,
    earlier), the mean of each pair;
  * ``chip_smoke.b4_bound`` and ``torch._grouped_mm`` on the same padded
    rows (``chip_smoke.b4_library``), cold as well;
  * at the three full-width training shapes, K4's forward
    (``grouped_matmul``) beside its byte bound and ``torch._grouped_mm``;
  * whether ``torch._grouped_mm`` takes float32 operands (B4's float32
    rows have no library time otherwise).

Prints the compiler's register, shared-memory and spill lines for both
builds, one JSON line a case (also appended to
``chiprun_out/b4_timing.jsonl``), then one with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = "f1e2ef4"
OUT = ROOT / "build" / "b4_parent"
LOG = ROOT / "chiprun_out" / "b4_timing.jsonl"
FULL_WIDTH = ("arctic_w_in", "arctic_w_out", "kimi_w_in")


@functools.lru_cache(maxsize=None)
def parent_plan(M, K, N, G, bm, sm_count) -> tuple:
    """The earlier ``bwd_plan`` for bf16 tensor-core operands: (walk,
    split_tiles, max_split, slots) -- dw blocks walk 4 N tiles of 128
    where the (expert, K band) pairs fill 16 waves of the card, and an
    expert is cut into slabs of at least 256 rows, at most 16384 rows over
    the walk, in 512 MB of partial slots."""
    t = 128
    n_kb, n_nb = -(-K // t), -(-N // t)
    walk = min(n_nb, 4) if G * n_kb >= 16 * sm_count else 1
    per = n_kb * -(-n_nb // walk)
    even = -(-M * per // (2 * sm_count))
    split_tiles = max(1, max(256, min(16384 // walk, even)) // bm)
    slots = min((1 << 29) // (n_kb * n_nb * t * t * 4),
                M // bm // split_tiles)
    if slots < 2 or G > 1024:
        slots = 0
    return walk, split_tiles, min(32, slots) if slots else 1, slots


def parent_library(rev: str, csrc: str | None):
    """The earlier B4 built and loaded, its C signatures declared; returns
    (library, compiler log)."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "moe_dispatch_bwd.cu"
    if csrc:
        src.write_bytes((Path(csrc) / "moe_dispatch_bwd.cu").read_bytes())
    else:
        src.write_bytes(subprocess.run(
            ["git", "show",
             f"{rev}:src/repro_torch/csrc/moe_dispatch_bwd.cu"],
            cwd=ROOT, capture_output=True, check=True).stdout)
    lib = OUT / "libmoe_dispatch_bwd_parent.so"
    proc = subprocess.run([build._nvcc(), *build.FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the earlier B4:\n{proc.stdout}"
                           f"{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    head = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    dll.mars_grouped_matmul_bwd_dx.restype = ctypes.c_int
    dll.mars_grouped_matmul_bwd_dx.argtypes = head + [ctypes.c_void_p]
    dll.mars_grouped_matmul_bwd_dw.restype = ctypes.c_int
    dll.mars_grouped_matmul_bwd_dw.argtypes = (head + [ctypes.c_int] * 3
                                               + [ctypes.c_void_p] * 3)
    return dll, proc.stdout + proc.stderr


def parent_fns(torch, lib, c, sm_count) -> dict:
    """The earlier B4's dx and dw launches on case ``c`` (bf16, the
    tensor-core path), each returning its gradient."""
    x, w, dout, tg, bm, n = (c[k] for k in ("x", "w", "dout", "tg", "bm",
                                             "n_used"))
    M, K = x.shape
    G, _, N = w.shape
    walk, split_tiles, max_split, slots = parent_plan(M, K, N, G, bm,
                                                      sm_count)
    part = counters = None
    if slots >= 2:
        tiles = slots * -(-K // 128) * -(-N // 128)
        part = torch.empty(tiles * 128 * 128, dtype=torch.float32,
                           device=x.device)
        counters = torch.zeros(tiles, dtype=torch.int32, device=x.device)
    n_ptr = None if n is None else n.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def dx():
        out = torch.empty_like(x)
        rc = lib.mars_grouped_matmul_bwd_dx(
            1, 1, dout.data_ptr(), w.data_ptr(), tg.data_ptr(), n_ptr,
            out.data_ptr(), M, K, N, G, bm, 128, stream())
        if rc:
            raise RuntimeError(f"earlier B4 dx failed: rc={rc}")
        return out

    def dw():
        out = torch.empty_like(w)
        rc = lib.mars_grouped_matmul_bwd_dw(
            1, 1, x.data_ptr(), dout.data_ptr(), tg.data_ptr(), n_ptr,
            out.data_ptr(), M, K, N, G, bm, walk, split_tiles, max_split,
            slots, None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"earlier B4 dw failed: rc={rc}")
        return out
    return {"dx": dx, "dw": dw}


def k4_forward(torch, cs, k4, c, flush, reps: int) -> dict:
    """K4's forward at case ``c``: cold ms, its byte bound (the live rows
    of x and the used experts' weights read once, out written whole) and
    ``torch._grouped_mm`` on the same padded rows."""
    x, w, tg, bm, n, offs = (c[k] for k in ("x", "w", "tg", "bm", "n_used",
                                             "offs"))
    M, K = x.shape
    G, _, N = w.shape
    moved = (c["live_rows"] * K + c["used_groups"] * K * N + M * N) * 2
    t_bytes = moved / cs.HBM_BYTES_PER_S * 1e3
    t_ops = 2 * c["A"] * K * N / cs.PEAK_OPS["bfloat16"] * 1e3
    out = dict(ms=cs.cold_ms(torch, lambda: k4.grouped_matmul(
        x, w, tg, bm=bm, n_tiles=n), reps, flush),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations")
    try:
        out["library_ms"] = cs.cold_ms(
            torch, lambda: torch._grouped_mm(x, w, offs=offs), reps, flush)
    except (RuntimeError, TypeError, ValueError, AttributeError) as e:
        out["library_ms"] = None
        out["library"] = str(e).splitlines()[0][:120]
    return out


def grouped_mm_f32(torch) -> str:
    """What ``torch._grouped_mm`` does with float32 operands of B4's dw
    form (two experts, 16-row segments)."""
    x = torch.randn(64, 32, device="cuda")
    d = torch.randn(32, 48, device="cuda")
    offs = torch.tensor([16, 32], dtype=torch.int32, device="cuda")
    try:
        torch._grouped_mm(x, d, offs=offs)
        torch.cuda.synchronize()
        return "takes float32"
    except (RuntimeError, TypeError, ValueError, AttributeError) as e:
        return f"refuses float32: {str(e).splitlines()[0][:160]}"


def compiler_lines(tag: str, log: str) -> None:
    for ln in log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"[build] {tag}: {ln.strip()[:160]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=PARENT,
                    help="git revision of the earlier kernels")
    ap.add_argument("--parent-csrc", default=None,
                    help="directory holding the earlier moe_dispatch_bwd.cu "
                         "(instead of --parent)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default=None,
                    help="comma-separated B4_CASES names (default: every "
                         "bfloat16 case)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("b4_timing: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_dispatch import moe_dispatch as k4
    compiler_lines("current", build.build_all(
        ("moe_dispatch", "moe_dispatch_bwd"))["moe_dispatch_bwd"])
    lib, log = parent_library(args.parent, args.parent_csrc)
    compiler_lines("parent", log)
    LOG.parent.mkdir(parents=True, exist_ok=True)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    want = set(args.cases.split(",")) if args.cases else None
    tol = tuple(2 * t for t in cs.B4_TOL["bfloat16"])
    ok = True
    for name, kind, spec, dtypes in cs.B4_CASES:
        if "bfloat16" not in dtypes or (want is not None
                                        and name not in want):
            continue
        c = cs.b4_case(torch, gen, kind, spec, torch.bfloat16)
        x, w = c["x"], c["w"]
        M, K = x.shape
        G, _, N = w.shape
        if K % 8 or N % 8:
            continue                   # CUDA cores in both trees
        parent = parent_fns(torch, lib, c, sm)
        current = {part: functools.partial(
            lambda part: k4.grouped_matmul_bwd(
                x, w, c["dout"], c["tg"], bm=c["bm"], n_tiles=c["n_used"],
                need_dx=part == "dx", need_dw=part == "dw")[
                    0 if part == "dx" else 1], part) for part in ("dx", "dw")}
        lib_fns, note = cs.b4_library(torch, c)
        row = dict(case=f"{name}/bfloat16", M=M, K=K, N=N, G=G, bm=c["bm"],
                   live_rows=c["live_rows"], experts_used=c["used_groups"],
                   parent_plan=dict(zip(("walk", "split_tiles", "max_split",
                                         "slots"),
                                        parent_plan(M, K, N, G, c["bm"],
                                                    sm))))
        for part in ("dx", "dw"):
            a, b = parent[part](), current[part]()
            torch.cuda.synchronize()
            if part == "dx":
                err = cs.bwd_err(b, a, tol)[1]
            else:
                err = max(cs.bwd_err(b[g:g + 8], a[g:g + 8], tol)[1]
                          for g in range(0, G, 8))
            del a, b
            ok = ok and err <= 1.0
            turns = {"parent": [], "current": []}
            for who in ("parent", "current", "current", "parent"):
                fn = (parent if who == "parent" else current)[part]
                turns[who].append(cs.cold_ms(torch, fn, args.reps, flush))
            bound = cs.b4_bound(c, part)
            row[part] = dict(
                parent_ms=sum(turns["parent"]) / 2,
                current_ms=sum(turns["current"]) / 2, turns_ms=turns,
                current_against_parent=err, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"],
                library_ms=None if lib_fns is None else cs.cold_ms(
                    torch, lib_fns[part], args.reps, flush))
            row[part]["current_over_bound"] = \
                row[part]["current_ms"] / row[part]["bound_ms"]
        row["library"] = note
        if name in FULL_WIDTH:
            row["k4_forward"] = k4_forward(torch, cs, k4, c, flush,
                                           args.reps)
        line = json.dumps(row)
        print(line, flush=True)
        with LOG.open("a") as f:
            f.write(line + "\n")
        del c, parent, current, lib_fns
        torch.cuda.empty_cache()
    print(json.dumps(dict(grouped_mm_float32=grouped_mm_f32(torch))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(device=smi, agree=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
