"""Multi-pod dry-run of the port (counterpart of
``repro/launch/dryrun.py``): every (arch x shape x mesh) cell, one JSON
line a cell, with nothing allocated and no arithmetic run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's cost and memory analyses.  The port has no
compiler to ask, so it runs its own step under stand-ins:

- **Ranks.** A mesh is a process group of the fake backend
  (``torch.testing._internal.distributed.fake_pg.FakeStore``) of world
  size 256 (16 x 16) or 512 (2 x 16 x 16), held by this one process as
  rank 0, so ``launch.mesh.device_mesh`` and the ``DTensor`` placement
  of ``sharding.rules`` run their own code.  The fake backend's
  collectives return without moving data.  Each cell opens its group and
  closes it (``fake_group``): a process has one default group.
- **Tensors.** Everything runs under ``FakeTensorMode``: shapes and
  dtypes, no storage, so the full-width arctic-480b and kimi-k2 states
  are never materialized.
- **The route.** The step runs the CPU route, through the kernels' plain
  twins (``"route": "plain"``): the CUDA extensions take no fake tensor.
  The MoE products, whose twins read the routing on the host, run their
  static bound on fake tensors (``kernels.moe_dispatch``).  Nothing is
  hidden from the card: the dry-run executes no arithmetic on any
  device, as the reference lowers on placeholder host devices.

A train cell places the parameters by ``rules.param_shardings`` and the
optimizer state by ``optim.state_shardings`` (Adafactor above 1e11
parameters, ``opt_config_for``), and traces one step of
``train.step.make_train_step`` on this rank's rows of the global batch:
the flops by ``torch.utils.flop_counter.FlopCounterMode``; the bytes
every op reads and writes, summed (an unfused upper bound, like the
reference's CPU-backend bytes); the collectives by
``utils.collectives.record``; and the memory: the arguments (this rank's
parameters, optimizer state and rows of the batch), the outputs, and the
temporaries, the peak of live bytes allocated during the step, with the
ops whose outputs hold most of them at the peak (``temp_peak_by_op``).

The step is tensor-parallel over ``model`` (``rules.model_cut``): a
rank computes with its heads, MLP units, vocabulary rows, SSM heads and
experts, and ``gathered_gb_per_chip`` counts those cuts and their
gradients: over ``model`` only cuts travel and are held, stored parts
exchanged by an all-to-all where the storage is not the cut
(``dtensor.fetch``, ``dtensor.return_grad``).

A serve cell places the parameters at ``fsdp=False`` and traces what
the reference lowers: a prefill cell ``lm.forward`` over this rank's
rows of the prompt (with the frontend where the config has one),
keeping the last position's logits (``trace_serve``); a decode cell one
``serve.step.make_decode_step`` step on this rank's part of the cache
under ``rules.cache_shardings`` (cut by KV heads, or by sequence, where
the step runs flash-decoding).  It records what a train cell records,
and the parameters and the cache per chip.

Roofline terms are the reference's formulas with the H100's spec-sheet
numbers in place of v5e's.  ``t_collective_s`` is a best case: one
NVLink's rate, while a mesh of 256 cards crosses nodes, where the link
is slower.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers, lm
from repro_torch.models.config import (SHAPES, ModelConfig, cell_applicable,
                                       shape_by_name)
from repro_torch.optim import adamw as optim
from repro_torch.sharding import context as shctx
from repro_torch.sharding import dtensor, rules
from repro_torch.train import step as train_step_mod
from repro_torch.utils import collectives
from repro_torch.utils.tree import leaf_paths, leaves, tree_map

# H100 80GB HBM3, 700 W, per card: the spec sheet's numbers, not
# measurements
PEAK_FLOPS = 989e12        # bf16 dense
HBM_BW = 3.35e12           # B/s
LINK_BW = 450e9            # B/s, NVLink 4, per direction

PEAK_OPS = 4               # ops named in a record's peak of temporaries

def opt_config_for(cfg: ModelConfig) -> optim.OptConfig:
    # trillion-scale MoE: factored second moment, bf16 has no full AdamW
    if cfg.n_params() > 1e11:
        return optim.OptConfig(kind="adafactor")
    return optim.OptConfig(kind="adamw")


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """The analytic flops of a step: 6 N_active B S to train (forward and
    backward), 2 N_active B S to prefill, 2 N_active B to decode."""
    n = cfg.n_active_params()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of the fake backend of ``world`` ranks,
    this process rank 0; destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already open: the dry-run "
                           "opens its own fake one (run it in a process "
                           "of its own)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def abstract_state(cfg: ModelConfig, mesh, *, fsdp: bool = True,
                   with_opt: bool = True, opt_cfg=None):
    """Meta parameters [+ optimizer state] and their specs on ``mesh``:
    (params, pshard, opt, oshard)."""
    params = lm.abstract_init(cfg)
    pshard = rules.param_shardings(lm.param_specs(cfg), params, mesh,
                                   fsdp=fsdp)
    if not with_opt:
        return params, pshard, None, None
    opt = optim.opt_init(params, opt_cfg)
    return params, pshard, opt, optim.state_shardings(opt, pshard, mesh)


def cache_bytes(cache, shard, mesh) -> int:
    """Bytes a device holds of an ``lm.Cache`` under its specs, leaf by
    leaf (a field without storage counts nothing)."""
    return sum(rules.sharded_bytes_per_device(
        getattr(cache, f.name), getattr(shard, f.name), mesh)
        for f in dataclasses.fields(cache)
        if getattr(cache, f.name) is not None)


def _span(t) -> int:
    """Bytes of a tensor, at most those of its storage (an expanded view
    reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class StepMeter(TorchDispatchMode):
    """Counts, over the ops run inside it: ``bytes``, what each op that is
    not a view reads and writes (its tensor arguments and outputs); and
    the bytes of the storages its ops allocate while they live, with
    their ``peak`` and, at the peak, the live bytes by the op that made
    them (``peak_by_op``).  Storages of ``known`` tensors (the arguments)
    are not counted.  A ``DTensor`` op is let through to ``DTensor``,
    whose local ops then reach the mode."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary
        self.bytes = self.live = self.peak = 0
        self.by_op: dict = {}
        self.peak_by_op: dict = {}
        self._seen = WeakIdKeyDictionary()
        for t in known:
            self._seen[t.untyped_storage()] = True

    def _free(self, op: str, n: int) -> None:
        self.live -= n
        self.by_op[op] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = collectives.flat_tensors(out)
        if not getattr(func, "is_view", False):
            ins = collectives.flat_tensors([*args, *kwargs.values()])
            self.bytes += sum(map(_span, ins)) + sum(map(_span, outs))
        for t in outs:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = True
                n, op = st.nbytes(), str(func)
                self.live += n
                self.by_op[op] = self.by_op.get(op, 0) + n
                if self.live > self.peak:
                    self.peak = self.live
                    self.peak_by_op = dict(self.by_op)
                weakref.finalize(st, self._free, op, n)
        return out


def _local_tensors(tree) -> list:
    return [dtensor.local(t) for t in leaves(tree)
            if isinstance(t, torch.Tensor)]


def _unique_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def fake_state(cfg: ModelConfig, mesh, opt_cfg, fsdp: bool = True,
               grads: bool = True):
    """Under ``FakeTensorMode``: this rank's parameters (``DTensor``s
    placed by ``rules.param_shardings`` on a mesh of processes; whole on
    a mesh of one), wanting gradients, and their optimizer state (with
    ``grads``; else the parameters alone, and None)."""
    meta, pshard, _, _ = abstract_state(cfg, mesh, fsdp=fsdp,
                                        with_opt=False)
    if mesh.dist is None:
        params = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype),
                          meta)
    else:
        here = dtensor.coords(mesh)
        params = tree_map(lambda m, spec: dtensor.distribute(torch.empty(
            rules.local_shape(spec, m.shape, mesh, here), dtype=m.dtype),
            spec, mesh), meta, pshard)
    params = layers.as_module(params)
    if not grads:
        return params, None
    for p in params.parameters():
        p.requires_grad_(True)
    return params, optim.opt_init(params, opt_cfg)


def fake_batch(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The global batch as fake tensors: tokens and labels, and an
    encoder-decoder or VLM model's frontend frames."""
    tok = torch.zeros((batch, seq), dtype=torch.int32)
    out = {"tokens": tok, "labels": tok}
    if cfg.frontend:
        out["frontend"] = torch.zeros((batch, cfg.frontend_seq,
                                       cfg.d_model), dtype=cfg.cdtype)
    return out


def trace_train(cfg: ModelConfig, mesh, batch: int, seq: int, *,
                opt_cfg=None, remat: bool = True, fsdp: bool = True,
                flop_counts: bool = False) -> dict:
    """One step of ``make_train_step(cfg, opt_cfg, TrainFlags(remat),
    mesh)`` on a global batch of ``batch`` x ``seq`` tokens under
    ``FakeTensorMode``, on a mesh of one or over the open fake group
    (``mesh.dist``).  Returns this rank's traced flops, bytes and
    collectives (``collectives.record``'s calls), its memory (bytes of
    the arguments, of the outputs, and the temporaries' peak), and with
    ``flop_counts`` the flops by op."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    opt_cfg = opt_cfg or opt_config_for(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params, opt = fake_state(cfg, mesh, opt_cfg, fsdp)
        data = fake_batch(cfg, batch, seq)
        bspec = rules.batch_sharding(mesh, batch)
        args = _local_tensors(params) + _local_tensors(opt)
        arg_bytes = _unique_bytes(args) + rules.sharded_bytes_per_device(
            data, {k: bspec for k in data}, mesh)
        step = train_step_mod.make_train_step(
            cfg, opt_cfg, train_step_mod.TrainFlags(remat=remat), mesh)
        out, (params, opt, metrics) = _metered(
            mesh, args + list(data.values()),
            lambda: step(params, opt, data), flop_counts)
        out["memory"]["argument_size_in_bytes"] = arg_bytes
        out["memory"]["output_size_in_bytes"] = _unique_bytes(
            _local_tensors(params) + _local_tensors(opt)
            + _local_tensors(metrics))
    return out


def _metered(mesh, known, fn, flop_counts: bool = False):
    """``fn()`` under the ambient ``mesh`` with its flops, bytes,
    collectives and temporaries counted (``known``: the arguments'
    tensors); returns (the counts, ``fn``'s result)."""
    from torch.utils.flop_counter import FlopCounterMode
    with shctx.use_mesh(mesh), FlopCounterMode(display=False) as fc, \
            collectives.record() as rec, StepMeter(known) as meter:
        res = fn()
    out = dict(flops=float(fc.get_total_flops()), bytes=float(meter.bytes),
               calls=rec.calls,
               memory=dict(temp_size_in_bytes=meter.peak,
                           temp_peak_by_op=dict(sorted(
                               ((k, v) for k, v in meter.peak_by_op.items()
                                if v), key=lambda kv: -kv[1])[:PEAK_OPS])))
    if flop_counts:
        out["flop_counts"] = {
            mod: {str(op): n for op, n in ops.items()}
            for mod, ops in fc.get_flop_counts().items()}
    return out, res


def trace_serve(cfg: ModelConfig, mesh, kind: str, batch: int,
                seq: int) -> dict:
    """A serve cell's step under ``FakeTensorMode`` over the open fake
    group (``mesh.dist``), the parameters placed at ``fsdp=False`` and
    this rank's cuts of them fetched before the step, once for the
    placement (``serve.step.cut_params``; the step's arguments):
    ``kind`` "prefill" runs ``lm.forward`` over this rank's rows of a
    (``batch``, ``seq``) prompt, with the frontend where the config has
    one, keeping the last position's logits; "decode" one
    ``serve.step.make_decode_step`` step of this rank's rows on its part
    of a cache of ``seq`` positions (``rules.cache_shardings``).  Returns
    what ``trace_train`` returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.serve import step as serve_step
    with FakeTensorMode(allow_non_fake_inputs=True):
        params, _ = fake_state(cfg, mesh, None, fsdp=False, grads=False)
        # fetched once for the placement: a step reads the cuts
        params = serve_step.cut_params(cfg, mesh, params)
        args = _local_tensors(params)
        rows = serve_step.serve_rows(mesh, batch)
        nb = rows.stop - rows.start
        if kind == "prefill":            # this rank's rows of the prompt
            data = fake_batch(cfg, nb, seq)
            data.pop("labels")
            known = list(data.values())

            def fn():
                with torch.no_grad():
                    return lm.forward_aux(params, cfg, data["tokens"],
                                          data.get("frontend"),
                                          last=True)[0]
        else:
            enc = cfg.frontend_seq if cfg.family == "encdec" else 0
            cache = lm.init_dense_cache(cfg, nb, seq, "cpu", enc_len=enc,
                                        tp=dtensor.model_rank(mesh))
            cache.length = torch.tensor(seq - 1, dtype=torch.int32)
            tok = torch.zeros((batch, 1), dtype=torch.int32)
            known = _cache_tensors(cache) + [tok]
            step = serve_step.make_decode_step(cfg, mesh)

            def fn():
                return step(params, cache, tok)[1]
        out, logits = _metered(mesh, args + known, fn)
        out["memory"]["argument_size_in_bytes"] = _unique_bytes(
            args + known)
        out["memory"]["output_size_in_bytes"] = _unique_bytes([logits])
    return out


def _cache_tensors(cache) -> list:
    return [getattr(cache, f.name) for f in dataclasses.fields(cache)
            if isinstance(getattr(cache, f.name), torch.Tensor)]


def analyze(traced: dict, chips: int, flops_model: float) -> dict:
    """The reference's roofline terms (``_analyze``) from a trace."""
    flops, bytes_ = traced["flops"], traced["bytes"]
    coll = collectives.collective_bytes(traced["calls"])
    # the analytic model flops are a floor for the executed matmul work
    mf_per_chip = flops_model / chips
    t_compute = max(flops, mf_per_chip) / PEAK_FLOPS
    t_memory = bytes_ / HBM_BW
    t_coll = coll.get("total", 0) / LINK_BW
    bound = max(t_compute, t_memory, t_coll)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "traced_flops_per_chip": flops,
        "traced_bytes_per_chip": bytes_,
        "collective_bytes_per_chip": coll.get("total", 0),
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "memory": traced["memory"],
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_chip": mf_per_chip,
        "useful_flop_ratio": mf_per_chip / flops if flops else 0.0,
        "roofline_bound_s": bound,
        "roofline_fraction": t_compute / bound if bound else 0.0,
    }


def plan_cell(cfg: ModelConfig, cell, mesh, fsdp: bool = True) -> dict:
    """The cell's planning numbers, from shapes alone: the parameters
    (and a train cell's optimizer state and the weights and gradients its
    step gathers, or a serve cell's cache) per chip in GB, the model
    flops per chip, the parameter counts."""
    chips = mesh.size
    rec = dict(chips=chips, n_params=cfg.n_params(),
               n_active=cfg.n_active_params(),
               model_flops_per_chip=model_flops(
                   cfg, cell.kind, cell.global_batch, cell.seq_len) / chips)
    if cell.kind == "train":
        params, pshard, opt, oshard = abstract_state(
            cfg, mesh, fsdp=fsdp, opt_cfg=opt_config_for(cfg))
        rec["opt_gb_per_chip"] = round(
            rules.sharded_bytes_per_device(opt, oshard, mesh) / 1e9, 3)
        # the step fetches each leaf's arithmetic cut whole over the data
        # axes (model rank 0's, the largest) and holds its gradient
        specs = lm.param_specs(cfg)
        n = mesh.shape["model"]
        gathered = sum(
            math.prod(rules.cut_shape(rules.model_cut(
                train_step_mod._at(specs, name), tuple(t.shape), cfg, n, 0),
                t.shape)) * t.element_size()
            for name, t in leaf_paths(params))
        rec["gathered_gb_per_chip"] = round(2 * gathered / 1e9, 3)
    else:
        params, pshard, _, _ = abstract_state(cfg, mesh, fsdp=False,
                                              with_opt=False)
        B = cell.global_batch
        cache = lm.abstract_cache(
            cfg, B, cell.seq_len,
            enc_len=cfg.frontend_seq if cfg.family == "encdec" else 0)
        rec["cache_gb_per_chip"] = round(
            cache_bytes(cache, rules.cache_shardings(mesh, cfg, B), mesh)
            / 1e9, 3)
    rec["params_gb_per_chip"] = round(
        rules.sharded_bytes_per_device(params, pshard, mesh) / 1e9, 3)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             fsdp: bool = True, remat: bool = True,
             kv_dtype: str = "") -> dict:
    cfg = configs.get(arch)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    cell = shape_by_name(shape_name)
    ok, why = cell_applicable(cfg, cell)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skip", reason=why)
        return rec
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        rec.update(plan_cell(cfg, cell, mesh, fsdp))
        with fake_group(mesh.size):
            on = mesh_mod.on_processes(mesh, "cpu")
            if cell.kind == "train":
                traced = trace_train(cfg, on, cell.global_batch,
                                     cell.seq_len, remat=remat, fsdp=fsdp)
            else:
                traced = trace_serve(cfg, on, cell.kind, cell.global_batch,
                                     cell.seq_len)
        rec.update(analyze(traced, mesh.size, model_flops(
            cfg, cell.kind, cell.global_batch, cell.seq_len)))
        rec.update(status="ok", route="plain",
                   trace_s=round(time.time() - t0, 1))
    except Exception as e:  # a cell's failure is its record, not the run's
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:],
                   trace_s=round(time.time() - t0, 1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"],
                    help="default single; with --all both")
    ap.add_argument("--all", action="store_true",
                    help="every cell, or those of the --arch, --shape "
                         "and --mesh given")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--kv-dtype", default="")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in configs.all_archs():
            for s in SHAPES:
                for mp in (False, True):
                    cells.append((a, s.name, mp))
        cells = [c for c in cells if args.arch in (None, c[0])
                 and args.shape in (None, c[1])
                 and args.mesh in (None, ("single", "multi")[c[2]])]
    else:
        cells = [(args.arch, args.shape, args.mesh == "multi")]

    out_fh = open(args.out, "a") if args.out else None
    try:
        for arch, shape, mp in cells:
            rec = run_cell(arch, shape, mp, fsdp=not args.no_fsdp,
                           remat=not args.no_remat, kv_dtype=args.kv_dtype)
            line = json.dumps(rec)
            print(line, flush=True)
            if out_fh:
                out_fh.write(line + "\n")
                out_fh.flush()
            if rec.get("status") == "ok":
                print(f"#  mem={rec['memory']}", flush=True)
                print(f"#  cost: flops/chip="
                      f"{rec['traced_flops_per_chip']:.3e} bytes/chip="
                      f"{rec['traced_bytes_per_chip']:.3e} coll/chip="
                      f"{rec['collective_bytes_per_chip']:.3e} "
                      f"dominant={rec['dominant']}", flush=True)
    finally:
        if out_fh:
            out_fh.close()


if __name__ == "__main__":
    main()
