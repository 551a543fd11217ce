#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero and prints no result):

  build   compile every CUDA kernel of the port from ``src/repro_torch/
          csrc`` with nvcc for sm_90a (one nvcc per source, started
          together) into the git-ignored ``build/``.
  kernel  hold each kernel against its plain PyTorch twin on the card
          (paged_attention with its softmax state, and decode_attend,
          whose twin is the same call on host copies) over the serving
          shapes, a long ragged pool, GQA, sliding windows, float32 and
          bfloat16; time the kernel at the serving and the long case
          beside its bound, the plain twin and one PyTorch library call.
  serve   ``repro_torch.launch.serve --paged --config qwen1_5_0_5b`` at
          full width (24 layers, vocab 151936, random weights from a
          seed): served tokens must pass the teacher-forced check against
          the port's dense backend, and the paged-attention kernel must
          have launched once per layer per dispatched decode step.
  profile the same serve run twice more, warm: plain for its wall time,
          then under ``torch.profiler`` for the device's kernel time by
          kernel and its busy share.

Prints the card's name and power limit (as ``nvidia-smi`` gives them), a
``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``; the full record goes to ``chiprun_out/
chip_smoke.json``.  Imports no JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS = {"float32": 67e12,        # H100 SXM, outside the tensor cores
            "bfloat16": 989e12}      # H100 SXM tensor cores, dense
TOL = {"float32": dict(o=(1e-4, 1e-4), ml=(1e-4, 1e-4)),
       "bfloat16": dict(o=(2e-2, 0.0), ml=(1e-5, 1e-3))}  # (atol, rtol)
OUT_DIR = ROOT / "chiprun_out"
SERVE_ARGS = ["--paged", "--config", "qwen1_5_0_5b", "--requests", "16",
              "--batch", "8", "--device", "cuda"]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` after
    warm-up.  At small shapes this includes the host's launch overhead
    (the card waits for the enqueue)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_rows(prof) -> list:
    """Device-side rows (kernels, copies) of a ``torch.profiler`` run:
    name, summed device ms and count, longest first."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append(dict(name=e.key, ms=us / 1e3, calls=e.count))
    return sorted(rows, key=lambda r: -r["ms"])


def device_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the summed time of every kernel
    it launches (``torch.profiler``), over ``reps`` calls after one
    warm-up call.  Host launch overhead is not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(r["ms"] for r in device_rows(prof)) / reps


def make_case(gen, *, B, H, Hkv, D, page, L, P, n_pages, lengths, dtype):
    """Random paged-attention operands on the card: distinct blocks per
    lane from a pool of P blocks, the given per-lane lengths."""
    import torch
    dev = gen.device
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(L, P, page, Hkv, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(L, P, page, Hkv, D, generator=gen, device=dev).to(dtype)
    kn = torch.randn(B, Hkv, D, generator=gen, device=dev).to(dtype)
    vn = torch.randn(B, Hkv, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)[:B * n_pages]
    pt = perm.reshape(B, n_pages).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, kn, vn, pt, ln


def close(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def kernel_phase(torch, gen):
    from repro_torch.kernels.paged_attention import paged_attention as pa_mod
    pa, plain = pa_mod.paged_attention, pa_mod.paged_attention_plain
    cases = []
    for dtype in ("float32", "bfloat16"):
        # serving shapes of qwen1.5-0.5b: 8 lanes, 16 heads (kv 16), d 64
        serve_len = [int(x) for x in torch.randint(
            1, 8 * 16, (8,), generator=gen, device=gen.device)]
        cases.append(("serve", dtype, dict(B=8, H=16, Hkv=16, D=64, page=16,
                                           L=24, P=256, n_pages=8,
                                           lengths=serve_len), 7, 0))
        # long ragged pool: 2048 blocks, lengths in [0, 4096], one empty
        long_len = [int(x) for x in torch.randint(
            0, 4097, (8,), generator=gen, device=gen.device)]
        long_len[3] = 0
        cases.append(("long", dtype, dict(B=8, H=16, Hkv=16, D=64, page=16,
                                          L=2, P=2048, n_pages=256,
                                          lengths=long_len), 1, 0))
        # GQA: n_rep 2 and 8, and 32 (two blocks of <= 16 query heads)
        for H, Hkv, D, page in ((8, 4, 128, 8), (16, 2, 64, 4),
                                (32, 1, 128, 16)):
            cases.append((f"gqa{H // Hkv}", dtype,
                          dict(B=4, H=H, Hkv=Hkv, D=D, page=page, L=3, P=64,
                               n_pages=12, lengths=[0, 5, 29, page * 12]),
                          2, 0))
        for window in (1, 64):
            cases.append((f"window{window}", dtype,
                          dict(B=8, H=16, Hkv=16, D=64, page=16, L=4,
                               P=512, n_pages=32,
                               lengths=[0, 1, 63, 64, 65, 200, 511, 512]),
                          3, window))
    results, max_err = [], 0.0
    timed = {}
    for name, dtype, shp, layer, window in cases:
        q, kp, vp, kn, vn, pt, ln = make_case(gen, dtype=getattr(torch, dtype),
                                              **shp)
        o, m, l = pa(q, kp, vp, pt, ln, layer=layer, window=window,
                     return_state=True)
        torch.cuda.synchronize()
        o2, m2, l2 = plain(q, kp, vp, pt, ln, layer=layer, window=window)
        tol = TOL[dtype]
        ok_o, e_o = close(o, o2, *tol["o"])
        ok_m, e_m = close(m, m2, *tol["ml"])
        ok_l, e_l = close(l, l2, *tol["ml"])
        d = pa_mod.decode_attend(q, kn, vn, kp, vp, pt, ln, layer=layer,
                                 window=window)
        torch.cuda.synchronize()
        # decode_attend's plain twin: the same call on host copies, where
        # paged_attention runs its plain version
        d2 = pa_mod.decode_attend(*(t.cpu() for t in (q, kn, vn, kp, vp, pt,
                                                      ln)),
                                  layer=layer, window=window)
        ok_d, e_d = close(d.cpu(), d2, *tol["o"])
        line = (f"[kernel] {name:9s} {dtype:8s} o_err={e_o:.3e} "
                f"m_err={e_m:.3e} l_err={e_l:.3e} decode_err={e_d:.3e} "
                f"tol(o atol,rtol)={tol['o']} tol(m,l)={tol['ml']} "
                f"{'ok' if ok_o and ok_m and ok_l and ok_d else 'MISMATCH'}")
        print(line)
        results.append(dict(case=name, dtype=dtype, o_err=e_o, m_err=e_m,
                            l_err=e_l, decode_err=e_d,
                            ok=ok_o and ok_m and ok_l and ok_d))
        max_err = max(max_err, e_o, e_d)
        if name in ("serve", "long"):
            timed[(name, dtype)] = (q, kp, vp, pt, ln, layer, shp)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain twin: {bad}")
    return results, max_err, timed


def time_case(torch, F, ops, dtype: str):
    """Kernel, plain twin and SDPA (over pre-gathered keys) at one case,
    as device time per call and as event time per call with the host's
    launch; bound from the bytes and operations this case's data needs."""
    from repro_torch.kernels.paged_attention import paged_attention as pa_mod
    q, kp, vp, pt, ln, layer, shp = ops
    B, H, D = q.shape
    Hkv, page = shp["Hkv"], shp["page"]
    eb = q.element_size()
    valid = int(ln.sum())
    pages = int(((ln + page - 1) // page).sum())
    bytes_moved = (2 * valid * Hkv * D * eb          # valid K and V rows
                   + 2 * B * H * D * eb              # q in, o out
                   + 2 * B * H * 4                   # m, l out
                   + pages * 4 + B * 4)              # page-table entries, lengths
    ops_count = 4 * valid * H * D                    # q.k and p.v
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / PEAK_OPS[dtype] * 1e3

    def kern():
        pa_mod.paged_attention(q, kp, vp, pt, ln, layer=layer,
                               return_state=True)

    def plain():
        pa_mod.paged_attention_plain(q, kp, vp, pt, ln, layer=layer)
    # library yardstick: SDPA over the same keys gathered contiguously
    # beforehand (the gather is excluded); lanes as the batch, the same
    # valid-position mask; never called by the port
    S = pt.shape[1] * page
    kg = kp[layer][pt.long()].reshape(B, S, Hkv, D).transpose(1, 2) \
        .contiguous()
    vg = vp[layer][pt.long()].reshape(B, S, Hkv, D).transpose(1, 2) \
        .contiguous()
    mask = (torch.arange(S, device=q.device)[None, :] < ln[:, None].long()
            )[:, None, None, :]
    q4 = q[:, :, None, :]

    def lib():
        F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
    return dict(ms=device_ms(kern, 50), plain_ms=device_ms(plain, 10),
                library_ms=device_ms(lib, 50),
                event_ms=time_ms(kern, 50),
                plain_event_ms=time_ms(plain, 10),
                library_event_ms=time_ms(lib, 50),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, ops=ops_count, valid_positions=valid)


def profile_serve(torch, serve, args) -> dict:
    """The serve run twice more, warm: once plain (engine wall time), once
    under ``torch.profiler`` (summed device time by kernel and its share
    of the profiled wall, the paged-attention kernel's part, and the host
    ops with the most self time)."""
    from torch.profiler import ProfilerActivity, profile
    args = args + ["--parity-checks", "0"]
    t0 = time.perf_counter()
    warm = serve.main(args)              # warm, no profiler
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    buckets: dict = {}
    for r in rows:
        n = r["name"].lower()
        b = ("paged_attention" if "paged_attention" in n else
             "memcpy" if "memcpy" in n or "memset" in n else
             "gemm" if any(k in n for k in ("gemm", "nvjet", "cutlass",
                                            "xmma", "cublas")) else
             "other")
        buckets[b] = buckets.get(b, 0.0) + r["ms"]
    pa = [r for r in rows if "paged_attention" in r["name"]]
    dev_ms = sum(r["ms"] for r in rows)
    host = sorted(({"name": e.key, "ms": e.self_cpu_time_total / 1e3,
                    "calls": e.count} for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda r: -r["ms"])
    return dict(warm_engine_wall_s=warm["wall_s"], warm_wall_s=warm_wall,
                warm_decode_tokens=warm["decode_tokens"],
                warm_decode_steps=warm["decode_steps"],
                wall_s=wall, device_ms=dev_ms,
                busy_share=dev_ms / 1e3 / wall,
                paged_attention_ms=sum(r["ms"] for r in pa),
                paged_attention_calls=sum(r["calls"] for r in pa),
                by_kind_ms=buckets, top=rows[:12],
                host_ms=sum(r["ms"] for r in host), host_top=host[:12])


def main() -> int:
    try:
        import torch
        import torch.nn.functional as F
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: no GPU to run on")
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.paged_attention import \
            paged_attention as pa_mod
        from repro_torch.launch import serve
    except ImportError as e:
        return fail(f"cannot import the port ({e}); run from a checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} kernel source(s) in {build_s:.1f}s "
          f"(nvcc sm_90a)")
    for name, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")

    # -- kernel vs plain twin ------------------------------------------------
    gen = torch.Generator("cuda").manual_seed(0)
    results, max_err, timed = kernel_phase(torch, gen)
    timing = {f"{name}/{dt}": time_case(torch, F, ops, dt)
              for (name, dt), ops in timed.items()}
    for case, t in timing.items():
        print(f"[kernel] {case}: device ms per call: kernel {t['ms']:.4f}, "
              f"bound {t['bound_ms']:.4f} ({t['bound_by']}; {t['bytes']} B,"
              f" {t['ops']} ops, {t['valid_positions']} valid positions), "
              f"plain twin {t['plain_ms']:.4f}, SDPA over pre-gathered keys"
              f" (gather excluded) {t['library_ms']:.4f}; event ms per "
              f"call with host launch: {t['event_ms']:.4f} / "
              f"{t['plain_event_ms']:.4f} / {t['library_event_ms']:.4f}")

    # -- serve at full width -------------------------------------------------
    pa_mod.paged_attention.launches = 0
    out = serve.main(SERVE_ARGS)
    launches = pa_mod.paged_attention.launches
    cfg = serve.configs.get("qwen1_5_0_5b")
    want = cfg.n_layers * out["decode_steps"]
    print(f"[serve] served={out['served']} decode_tokens="
          f"{out['decode_tokens']} engine_steps={out['steps']} "
          f"decode_steps={out['decode_steps']} wall={out['wall_s']:.3f}s "
          f"tokens/s={out['decode_tokens'] / out['wall_s']:.1f} "
          f"paged_attention launches={launches} (want {want}) "
          f"parity_mismatches={out['parity_mismatches']}")
    if out["served"] != 16 or out["parity_mismatches"]:
        return fail(f"serve phase: {out['served']} served, "
                    f"{out['parity_mismatches']} parity mismatches")
    if launches == 0 or launches != want:
        return fail(f"paged_attention launched {launches} times on the "
                    f"main path, want {want}")
    bad = [t for toks in out["finished"].values() for seq in toks
           for t in seq if not 0 <= t < cfg.vocab]
    if bad or any(len(seq) != 8 for toks in out["finished"].values()
                  for seq in toks):
        return fail("served tokens out of range or of the wrong count")

    prof = profile_serve(torch, serve, SERVE_ARGS)
    print(f"[profile] warm serve: engine wall {prof['warm_engine_wall_s']:.3f}"
          f"s for {prof['warm_decode_tokens']} decode tokens "
          f"({prof['warm_decode_tokens'] / prof['warm_engine_wall_s']:.1f} "
          f"tokens/s, {prof['warm_decode_steps']} decode steps)")
    print(f"[profile] warm serve under torch.profiler: wall "
          f"{prof['wall_s']:.3f}s, device kernel time "
          f"{prof['device_ms']:.1f} ms (busy share "
          f"{prof['busy_share']:.3f}), paged_attention "
          f"{prof['paged_attention_ms']:.2f} ms over "
          f"{prof['paged_attention_calls']} launches")
    print(f"[profile]   device ms by kind: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(prof["by_kind_ms"].items())))
    for row in prof["top"]:
        print(f"[profile]   {row['ms']:9.3f} ms {row['calls']:6d}x "
              f"{row['name'][:90]}")
    print(f"[profile] host self time of profiled ops "
          f"{prof['host_ms']:.1f} ms; longest:")
    for row in prof["host_top"]:
        print(f"[profile]   {row['ms']:9.3f} ms {row['calls']:6d}x "
              f"{row['name'][:90]}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    t = timing["long/bfloat16"]
    kernels = [dict(name="paged_attention", route="cuda",
                    source="src/repro_torch/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention/"
                             "paged_attention.py:57",
                    launches=launches, max_abs_err=max_err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=t["library_ms"])]
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, build_s=build_s, cases=results, timing=timing,
        serve={k: v for k, v in out.items() if k != "finished"},
        launches=launches, profile=prof), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
