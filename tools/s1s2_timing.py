#!/usr/bin/env python3
"""Time the paper simulator's kernels S1 (``mars_engine``) and S2
(``dram_channel``) against an earlier version of each, on one GPU, in
one process.

    python3 tools/s1s2_timing.py [--parent REV | --parent-csrc DIR]
                                 [--rpc 256] [--grid-rpc 128] [--reps 3]

The earlier kernels (one block of one warp a call for S1, one warp a
channel for S2) are built with ``nvcc`` (the flags of
``repro_torch.kernels.build``) from ``REV``'s ``src/repro_torch/csrc/
{mars_engine,dram_channel}.cu`` (``git show``; default 82b1089), or from
the copies in ``DIR`` where the checkout has no ``.git``, into the
git-ignored ``build/s1s2_parent/``, and called through ctypes with their
own C signatures; the current ones through the port's wrappers
(``mars_engine_many``, ``dram_channels``).  Cases, each with both
versions' integers compared (the permutation and stats a stream; t_end,
n_act and hits a channel):

  * S1 a stream: WL1-WL5 at ``--rpc`` requests a core (the paper's GPU,
    n = 16384 at 256), one call each;
  * S1 ``run_all``: the five streams, one batched launch against five
    earlier launches;
  * S1 sweep: the 90 (grid point, workload) streams of
    ``benchmarks/ablations`` at ``--grid-rpc``, one batched launch
    against 90 earlier launches;
  * S2 a stream: each workload's baseline and MARS-ordered stream;
  * S2 ``run_all``: the ten streams, one launch against ten;
  * S2 sweep: the five baselines and 90 MARS-ordered streams in one
    launch against the earlier sweep's 180 (a baseline and a reordered
    stream a point and workload).

Device ms come from CUDA events around ``--reps`` calls after one
warm-up call, in turns (earlier, current, current, earlier), the mean
of each pair.  Beside them: simulated steps (S1 cycles x (n_ports + 1),
S2 requests of the longer channel) and ns a step, the byte bound
(``chip_smoke.sim_bytes_*`` over 3.35 TB/s) and the chain bound (the
longest instance's steps times one dependent shared-memory load, timed
here by one thread chasing pointers through shared memory,
``chip_smoke.smem_load_ns``).  Then the host's wall time of
``experiment.run_all`` and of the ablation sweep on the card (twice
each).  Prints one JSON line a case, then one with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PARENT = "82b1089"
NAMES = ("mars_engine", "dram_channel")
OUT = ROOT / "build" / "s1s2_parent"


def parent_libraries(rev: str, csrc: str | None) -> dict:
    """The earlier S1 and S2 as loaded libraries, their C signatures
    declared."""
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for name in NAMES:
        src = OUT / f"{name}.cu"
        if csrc:
            src.write_bytes((Path(csrc) / f"{name}.cu").read_bytes())
        else:
            src.write_bytes(subprocess.run(
                ["git", "show", f"{rev}:src/repro_torch/csrc/{name}.cu"],
                cwd=ROOT, capture_output=True, check=True).stdout)
        srcs[name] = src
    jobs = {}
    for name, src in srcs.items():            # one nvcc a source, together
        lib = OUT / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    fn = libs["mars_engine"].mars_engine_run
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 3)
    fn = libs["dram_channel"].dram_channels_run
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p] * 2)
    return libs


def parent_s1(torch, lib, inst):
    """The earlier S1 on one instance: (perm, stats)."""
    from repro_torch.core.mars import n_cycles
    pages, port_req, port_len, src, n_cores, cfg = inst
    n = pages.numel()
    perm = torch.full((n,), -1, dtype=torch.int64, device="cuda")
    stats = torch.zeros(3, dtype=torch.int32, device="cuda")
    rc = lib.mars_engine_run(
        pages.data_ptr(), port_req.data_ptr(), port_len.data_ptr(),
        src.data_ptr(), n, port_req.shape[1], max(n_cores, 1),
        cfg.request_q, cfg.nsets, cfg.ways, cfg.order_q, cfg.n_ports,
        cfg.mshr_per_core, n_cycles(n, cfg), perm.data_ptr(),
        stats.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier S1 failed: rc={rc}")
    return perm, stats


def parent_s2(torch, lib, ops, cfg):
    """The earlier S2 on one stream's channels: int32 (channels, 3)."""
    local, wr, off = ops
    out = torch.zeros((off.numel() - 1, 3), dtype=torch.int32, device="cuda")
    rc = lib.dram_channels_run(
        local.data_ptr(), wr.data_ptr(), off.data_ptr(), off.numel() - 1,
        cfg.window, cfg.n_banks, cfg.lines_per_row, cfg.t_rcd, cfg.t_rp,
        cfg.t_burst, cfg.t_ccd, cfg.t_rrd, cfg.t_faw, cfg.t_wtr, cfg.t_rtw,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier S2 failed: rc={rc}")
    return out


def event_ms(torch, fn, reps: int) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``reps``
    calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def turns(torch, fns: dict, reps: int) -> dict:
    """ms a call of the earlier and the current version, timed earlier,
    current, current, earlier; the mean of each pair."""
    got = {"parent": [], "current": []}
    for who in ("parent", "current", "current", "parent"):
        got[who].append(event_ms(torch, fns[who], reps))
    return {f"{who}_ms": sum(t) / len(t) for who, t in got.items()}


def s1_cases(torch, cs, libs, args, load_ns):
    from repro_torch.benchmarks import ablations
    from repro_torch.core import mars, streams
    from repro_torch.kernels.mars_engine import mars_engine as me
    lib = libs["mars_engine"]
    cfg0 = mars.MarsConfig()
    wl = {w: cs.sim_streams(w, args.rpc) for w in streams.WORKLOADS}
    one = {w: cs.sim_instance(torch, *wl[w][:3], cfg0) for w in wl}
    grid_wl = {w: cs.sim_streams(w, args.grid_rpc) for w in wl}
    grid = [cs.sim_instance(torch, *grid_wl[w][:3], cfg)
            for _, _, cfg in ablations.configs() for w in streams.WORKLOADS]
    groups = [(f"{w}/rpc{args.rpc}", [one[w]], args.reps) for w in one]
    groups += [(f"run_all/rpc{args.rpc}", list(one.values()), args.reps),
               (f"sweep/rpc{args.grid_rpc}", grid, 1)]
    for case, insts, reps in groups:
        new = me.mars_engine_many(insts)
        old = [parent_s1(torch, lib, i) for i in insts]
        same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                   for a, b in zip(new, old))
        stats = [s.tolist() for _, s in new]
        steps = [s[2] * (i[5].n_ports + 1) for s, i in zip(stats, insts)]
        nbytes = sum(map(cs.sim_bytes_mars, insts))
        row = dict(kernel="mars_engine", case=case, instances=len(insts),
                   equal_parent=bool(same), launches_parent=len(insts),
                   launches_current=1, cycles=[s[2] for s in stats],
                   stall_events=[s[1] for s in stats],
                   **turns(torch, {
                       "parent": lambda: [parent_s1(torch, lib, i)
                                          for i in insts],
                       "current": lambda: me.mars_engine_many(insts)}, reps),
                   longest_steps=max(steps),
                   bytes_bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                   chain_bound_ms=max(steps) * load_ns * 1e-6)
        row["speedup"] = row["parent_ms"] / row["current_ms"]
        row["ns_per_step"] = 1e6 * row["current_ms"] / max(steps)
        row["parent_ns_per_step"] = 1e6 * row["parent_ms"] / sum(steps)
        print(json.dumps(row), flush=True)
    return {w: one[w] for w in one}, grid


def s2_cases(torch, cs, libs, args, load_ns, one, grid):
    from repro_torch.core import dram, streams
    from repro_torch.kernels.dram_channel import dram_channel as dc
    from repro_torch.kernels.mars_engine import mars_engine as me
    lib = libs["dram_channel"]
    cfg = dram.DramConfig()

    def streams_of(rpc, insts):
        """(name, addr, is_write) of each workload's baseline stream at
        ``rpc`` and of each instance's reordered stream."""
        base = [(w,) + cs.sim_streams(w, rpc)[::3] for w in streams.WORKLOADS]
        perms = [p.cpu().numpy() for p, _ in me.mars_engine_many(insts)]
        n = len(base)
        return base + [(f"{base[i % n][0]}/mars{i // n}",
                        base[i % n][1][p], base[i % n][2][p])
                       for i, p in enumerate(perms)]
    main = streams_of(args.rpc, list(one.values()))
    sweep = streams_of(args.grid_rpc, grid)
    ops_of = {id(s): cs.sim_channel_operands(torch, s[1], s[2], cfg)
              for s in main + sweep}

    def together(ss):
        return cs.sim_concat_operands(torch, [ops_of[id(s)] for s in ss])
    n = len(streams.WORKLOADS)
    groups = [(f"{s[0]}/rpc{args.rpc}", [s], [s], args.reps) for s in main]
    groups += [(f"run_all/rpc{args.rpc}", main, main, args.reps),
               (f"sweep/rpc{args.grid_rpc}", sweep,
                [sweep[i % n] for i in range(len(sweep) - n)]
                + sweep[n:], 1)]
    for case, ss, old_ss, reps in groups:
        big = together(ss)
        new = dc.dram_channels(*big, cfg)
        old = torch.cat([parent_s2(torch, lib, ops_of[id(s)], cfg)
                         for s in ss])
        steps = [int(v) for o in (ops_of[id(s)] for s in ss)
                 for v in torch.diff(o[2]).tolist()]
        row = dict(kernel="dram_channel", case=case, streams=len(ss),
                   equal_parent=bool(torch.equal(new, old)),
                   launches_parent=len(old_ss), launches_current=1,
                   **turns(torch, {
                       "parent": lambda: [parent_s2(torch, lib, ops_of[id(s)],
                                                    cfg) for s in old_ss],
                       "current": lambda: dc.dram_channels(*big, cfg)}, reps),
                   longest_steps=max(steps),
                   bytes_bound_ms=cs.sim_bytes_channels(big)
                   / cs.HBM_BYTES_PER_S * 1e3,
                   chain_bound_ms=max(steps) * load_ns * 1e-6)
        row["speedup"] = row["parent_ms"] / row["current_ms"]
        row["ns_per_step"] = 1e6 * row["current_ms"] / max(steps)
        row["parent_ns_per_step"] = 1e6 * row["parent_ms"] / max(steps) \
            if len(ss) == 1 else None
        print(json.dumps(row), flush=True)


def walls(torch, args):
    """Host wall seconds of ``experiment.run_all`` at ``--rpc`` and of the
    ablation sweep at ``--grid-rpc`` on the card, twice each."""
    from repro_torch.benchmarks import ablations
    from repro_torch.core import experiment
    for case, fn in (("run_all", lambda: experiment.run_all(
            reqs_per_core=args.rpc, device="cuda")),
                     ("ablation_sweep", lambda: ablations.sweep(
                         "cuda", args.grid_rpc))):
        got = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            got.append(time.perf_counter() - t0)
        print(json.dumps(dict(case=f"wall/{case}", wall_s=got)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=PARENT,
                    help="git revision of the earlier kernels")
    ap.add_argument("--parent-csrc", default=None,
                    help="directory holding the earlier kernels' .cu files "
                         "(instead of --parent)")
    ap.add_argument("--rpc", type=int, default=256)
    ap.add_argument("--grid-rpc", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("s1s2_timing: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs          # streams, operands, byte counts
    from repro_torch.kernels import build
    for name, log in build.build_all(NAMES).items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[build] {name}: {ln.strip()[:160]}")
    libs = parent_libraries(args.parent, args.parent_csrc)
    chase = cs.smem_load_ns(torch)
    print(json.dumps(dict(case="smem_pointer_chase", **chase)), flush=True)
    one, grid = s1_cases(torch, cs, libs, args, chase["ns_per_load"])
    s2_cases(torch, cs, libs, args, chase["ns_per_load"], one, grid)
    walls(torch, args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
