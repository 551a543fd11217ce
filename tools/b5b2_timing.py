#!/usr/bin/env python3
"""Time the training backward kernels B5 (``flash_attention_bwd``) and B2
(``embedding_grad_scatter``) against an earlier version of each, on one
GPU, in one process.

    python3 tools/b5b2_timing.py [--parent REV | --parent-csrc DIR]
                                 [--only b5,b2] [--seed N]

The earlier kernels are built with ``nvcc`` (the flags of
``repro_torch.kernels.build``) from ``REV``'s ``src/repro_torch/csrc/
{flash_attention_bwd,embedding_grad_scatter}.cu`` (``git show``; default
657c261, the commit before B5's tensor-core kernels and B2's batched
walk), or from the copies in ``DIR`` where the checkout has no ``.git``,
into the git-ignored ``build/b5b2_parent/``, and called through ctypes
with their own C signatures; the current ones through the port's
wrappers.  B5: every case of ``chip_smoke.B5_CASES`` in bfloat16 and
float32, o and the rows' log-sum-exp from K5 (``flash_attention_with_
lse``; the earlier B5 recomputes the lse itself), the current kernel's
largest error against its plain twin (and its ratio to
``chip_smoke.b5_bounds``) and both versions' largest difference from
each other, then device ms per call in turns (earlier,
current, current, earlier; ``chip_smoke.counted_ms``, every launch in
the profile), SDPA's backward and the bound (``chip_smoke.b5_bound``).
B2: every ``chip_smoke.B2_TABLES`` table with TokenStream's zipf ids and
uniform ids, and every ``chip_smoke.B2_WORST`` case, float32 and
bfloat16: both versions bitwise against each other, then the zeroed
output and the kernel in the same turns, beside ``F.embedding``'s
backward and the bound.  Inputs come from ``--seed``.  Prints one JSON
line per case, then one with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = "657c261"
NAMES = ("flash_attention_bwd", "embedding_grad_scatter")
OUT = ROOT / "build" / "b5b2_parent"


def parent_libraries(rev: str, csrc: str | None) -> dict:
    """The earlier B5 and B2 as loaded libraries, their C signatures
    declared."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in NAMES:
        src = OUT / f"{name}.cu"
        if csrc:
            src.write_bytes((Path(csrc) / f"{name}.cu").read_bytes())
        else:
            src.write_bytes(subprocess.run(
                ["git", "show", f"{rev}:src/repro_torch/csrc/{name}.cu"],
                cwd=ROOT, capture_output=True, check=True).stdout)
        lib = OUT / f"lib{name}.so"
        subprocess.run([build._nvcc(), *build.FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(lib))
    fn = libs["flash_attention_bwd"].mars_flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_void_p])
    fn = libs["embedding_grad_scatter"].mars_embedding_grad_scatter
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    return libs


def parent_b5(torch, lib, q, k, v, o, do, causal: bool):
    """The earlier B5: three launches, its own lse and delta scratch."""
    B, Sq, H, D = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lse, delta = (torch.empty(B * H * Sq, dtype=torch.float32,
                              device=q.device) for _ in range(2))
    rc = lib.mars_flash_attention_bwd(
        {torch.float32: 0, torch.bfloat16: 1}[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), B, H, Sq, k.shape[1], D, int(causal),
        1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier B5 failed: rc={rc}")
    return dq, dk, dv


def parent_b2(torch, lib, sids, perm, g, V: int):
    """The earlier B2 on a zeroed output: one launch."""
    out = torch.zeros((V, g.shape[1]), dtype=g.dtype, device=g.device)
    rc = lib.mars_embedding_grad_scatter(
        {torch.float32: 0, torch.bfloat16: 1}[g.dtype], sids.data_ptr(),
        perm.data_ptr(), g.data_ptr(), out.data_ptr(), g.shape[0], V,
        g.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier B2 failed: rc={rc}")
    return out


def turns(cs, fns: dict, reps: int, case: str, key: str, per_call: int):
    """Device ms per call of the earlier and the current version, timed
    earlier, current, current, earlier; the mean of each pair."""
    got = {"parent": [], "current": []}
    for who in ("parent", "current", "current", "parent"):
        got[who].append(cs.counted_ms(fns[who], reps, f"{who} {case}", key,
                                      per_call))
    return {f"{who}_ms": sum(t) / len(t) for who, t in got.items()}


def b5_cases(torch, F, cs, libs, gen):
    from repro_torch.kernels.flash_attention import flash_attention as k5
    for dtype in ("bfloat16", "float32"):
        for name, B, Sq, Sk, H, D, causal in cs.B5_CASES:
            dt = getattr(torch, dtype)
            q, k, v = cs.k5_inputs(torch, gen, B, Sq, Sk, H, D, dt)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
            o, lse = k5.flash_attention_with_lse(q, k, v, causal=causal)
            new = k5.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                         lse=lse)
            old = parent_b5(torch, libs["flash_attention_bwd"], q, k, v, o,
                            do, causal)
            twin = k5.flash_attention_bwd_plain(q, k, v, o, do,
                                                causal=causal, lse=lse)
            torch.cuda.synchronize()
            err = [cs.bound_err(n, t, b) for n, t, b in zip(
                new, twin, cs.b5_bounds(k5, q, k, v, o, do, lse, causal,
                                        twin))]
            apart = [float((n.float() - p.float()).abs().max())
                     for n, p in zip(new, old)]
            del new, old, twin
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            dot = do.transpose(1, 2).contiguous()
            case = f"{name}/{dtype}"
            fns = {"parent": lambda: parent_b5(
                       torch, libs["flash_attention_bwd"], q, k, v, o, do,
                       causal),
                   "current": lambda: k5.flash_attention_bwd(
                       q, k, v, o, do, causal=causal, lse=lse)}
            row = dict(kernel="flash_attention_bwd", case=case,
                       err=[e[0] for e in err],
                       err_over_tol=[e[1] for e in err],
                       parent_apart=apart,
                       **turns(cs, fns, 10, case, "flash_bwd_",
                               k5.BWD_LAUNCHES),
                       library_ms=cs.device_ms(
                           lambda: torch.autograd.grad(
                               out, (qt, kt, vt), dot, retain_graph=True),
                           10, f"SDPA backward {case}"),
                       **cs.b5_bound(q, k, causal, dtype))
            row["speedup"] = row["parent_ms"] / row["current_ms"]
            print(json.dumps(row), flush=True)
            del q, k, v, o, do, lse, qt, kt, vt, out, dot, fns
            torch.cuda.empty_cache()


def b2_cases(torch, cs, libs, gen):
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels.mars_gather import mars_gather as mg
    from repro_torch.kernels.mars_gather import ops
    B, S = cs.TRAIN_TOKENS
    cases = []
    for tname, (V, D) in cs.B2_TABLES.items():
        cases += [(tname, V, D, "zipf"), (tname, V, D, "uniform")]
    cases += list(cs.B2_WORST)
    for tname, V, D, kind in cases:
        if kind == "uniform":
            ids_np = np.random.default_rng(3).integers(0, V, (B, S))
        elif kind == "one_id":
            ids_np = np.full((B, S), 1)
        else:
            ids_np = next(TokenStream(DataConfig(
                vocab=V, seq_len=S, global_batch=B)))["tokens"]
        ids = torch.from_numpy(ids_np.astype(np.int32)).cuda()
        for dtype in ("bfloat16", "float32"):
            g = torch.randn(B, S, D, generator=gen, device="cuda") \
                .to(getattr(torch, dtype))
            sids, perm, g2 = ops._sort(ids, g)
            new = mg.scatter_add_rows(sids, perm, g2, V)
            old = parent_b2(torch, libs["embedding_grad_scatter"], sids,
                            perm, g2, V)
            torch.cuda.synchronize()
            same = bool(torch.equal(new, old))
            del new, old
            flat = ids.reshape(-1).long()
            nbytes = g2.numel() * g2.element_size() + 16 * sids.numel() \
                + V * D * g2.element_size()
            case = f"{tname}/{kind}/{dtype}"
            fns = {"parent": lambda: parent_b2(
                       torch, libs["embedding_grad_scatter"], sids, perm, g2,
                       V),
                   "current": lambda: mg.scatter_add_rows(sids, perm, g2, V)}
            row = dict(kernel="embedding_grad_scatter", case=case,
                       bitwise_equal_parent=same,
                       longest_run=int(np.bincount(ids_np.ravel()).max()),
                       **turns(cs, fns, 20, case, "embedding_grad_scatter",
                               1),
                       library_ms=cs.device_ms(
                           lambda: torch.ops.aten.embedding_dense_backward(
                               g2, flat, V, -1, False), 20,
                           f"F.embedding backward {case}"),
                       bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                       bytes=nbytes)
            row["speedup"] = row["parent_ms"] / row["current_ms"]
            print(json.dumps(row), flush=True)
            del g, g2, sids, perm, fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=PARENT,
                    help="git revision of the earlier kernels")
    ap.add_argument("--parent-csrc", default=None,
                    help="directory holding the earlier kernels' .cu files "
                         "(instead of --parent)")
    ap.add_argument("--only", default="b5,b2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("b5b2_timing: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs          # case lists and timers
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, log in build.build_all(NAMES).items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build] {name}: {ln.strip()[:160]}")
    libs = parent_libraries(args.parent, args.parent_csrc)
    gen = torch.Generator("cuda").manual_seed(args.seed)
    cs.warm_profiler(torch)
    only = set(args.only.split(","))
    if "b5" in only:
        b5_cases(torch, F, cs, libs, gen)
    if "b2" in only:
        b2_cases(torch, cs, libs, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
