"""End-to-end training driver (port of ``repro/launch/train.py``).

``python -m repro_torch.launch.train --arch qwen1_5_0_5b --steps 30``
(on the card; ``--smoke --device cpu`` on the CPU)

Wires together: config registry -> model init -> data pipeline -> train
step -> checkpoint/restart + heartbeat/straggler supervision, with the
reference's flags and ``--device`` (default ``cuda``, which raises
without a card).  The weights are the port's random init from seed 0
(``lm.init``); batches are ``TokenStream``'s, bitwise the reference's;
an encoder-decoder or VLM model reads the reference's zero frontend
(``--frontend zeros``, the default) or stub frames (``--frontend stub``:
normal * 0.02, the serve path's stub, drawn anew each step from a
generator seeded with the step, so a resumed run draws the same).  At
whisper-base's full width the zero frontend trains nothing, in the
reference as here: every encoder LayerNorm sees zero variance, the
gradient through them overflows the float32 global norm to inf, and the
clip scales every update to 0 (ROADMAP.md §3).

On the card the forward runs K5 (attention with no mask or a causal one),
K2 (the sorted embedding gather), K3 (the SSM layers' chunked scan) and
K4 (the MoE layers' grouped products), whose gradients are the kernels
B5, B2, B3 and B4: every family trains on the card.  K5 at a head dim B5
does not take (112, 256) raises at its first call.  There is no quiet
switch to the plain twins; on the CPU every family trains through them.

The mesh is the reference's ``pick_mesh`` over the processes: one
process (no ``RANK``/``WORLD_SIZE`` in the environment and no process
group) is a mesh of one, whose parameters stay plain tensors.  Under
``torchrun`` (or ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set) the run opens the process group (gloo on the CPU,
NCCL on CUDA), or joins one already open, and holds the parameters,
gradients and optimizer state as ``DTensor``s placed by the
reference's rules (``sharding.rules.param_shardings``,
``optim.state_shardings``), each rank drawing only its part of the
initial parameters (``layers.LocalDraw``, bitwise the one-process
init's slice); the step runs over the mesh (``train.step``).
``check_trainable`` refuses on CUDA, before anything is built, a config
whose training state per device (``sharded_bytes_per_device`` of the
parameters, their gradients and the optimizer state under the run's
mesh) exceeds the card's memory: on one 80 GB card, the full-width
arctic-480b, kimi-k2, starcoder2-7b, phi3-medium-14b and
deepseek-coder-33b.

Checkpoints go to ``--workdir``, by default ``build/train/<config>``
under the checkout (git-ignored; the config's name tells a smoke run
from a full-width one), so ``--resume`` finds only the same config's.
A sharded run writes the files a one-process run writes (rank 0 writes
the gathered leaves) and resumes from either's.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.manager import RunSupervisor
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers, lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as optim
from repro_torch.sharding import context as shctx
from repro_torch.sharding import dtensor, rules
from repro_torch.train.step import TrainFlags, make_train_step
from repro_torch.utils.tree import leaves, tree_map

WORKDIR = Path(__file__).resolve().parents[3] / "build" / "train"


class StateTooLarge(RuntimeError):
    """A config's training state does not fit the card."""


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so ``lm.init`` lays
    the parameters out there: shapes and dtypes, no storage, no draws."""

    @property
    def device(self):
        return torch.device("meta")


def pick_mesh(n: int | None = None, device="cpu") -> mesh_mod.Mesh:
    """The reference's ``pick_mesh`` over ``n`` processes (default: the
    process group's size, 1 without one): the production meshes at 512
    and 256, else the largest (data, model) split with a model axis of
    16, 8, 4, 2 or 1.  Position r is rank r, on ``device``'s kind (a
    CUDA rank on card r modulo the cards there are)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    if n >= 512:
        mesh = mesh_mod.make_production_mesh(multi_pod=True)
    elif n >= 256:
        mesh = mesh_mod.make_production_mesh()
    else:
        model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
        mesh = mesh_mod.Mesh(("data", "model"),
                             {"data": n // model, "model": model}, ())
    kind = torch.device(device).type
    count = torch.cuda.device_count() if kind == "cuda" else 0
    devs = tuple(torch.device("cuda", r % count) if count
                 else torch.device(kind) for r in range(mesh.size))
    return mesh_mod.Mesh(mesh.axis_names, mesh.shape, devs)


def train_state(cfg: ModelConfig, opt_cfg=None) -> dict:
    """The training state of ``cfg`` laid out on the meta device (shapes
    and dtypes, no storage): its parameters (``lm.init``), one gradient
    of each parameter's shape and dtype, and the optimizer's state
    (``optim.opt_init``; AdamW's two moments, f32 master copy and step
    by default)."""
    params = lm.init(cfg, _MetaGenerator())
    return {"p": params, "g": params,
            "o": optim.opt_init(params, opt_cfg or optim.OptConfig())}


def train_state_bytes(cfg: ModelConfig, opt_cfg=None, mesh=None) -> int:
    """Bytes of ``cfg``'s training state (``train_state``) on one device:
    all of it, or under ``mesh`` each leaf's part as
    ``sharding.rules.sharded_bytes_per_device`` counts it, with the
    parameters and their gradients placed by ``param_shardings`` and the
    optimizer state by ``optim.state_shardings``."""
    state = train_state(cfg, opt_cfg)
    if mesh is None:
        return sum(t.numel() * t.element_size() for t in leaves(state))
    pshard = rules.param_shardings(lm.param_specs(cfg), state["p"], mesh)
    shard = {"p": pshard, "g": pshard,
             "o": optim.state_shardings(state["o"], pshard, mesh)}
    return rules.sharded_bytes_per_device(state, shard, mesh)


def card_memory(device) -> int:
    """Bytes of device memory of the card ``device`` names (raises when
    there is no card, as ``resolve_device`` does)."""
    return torch.cuda.get_device_properties(
        resolve_device(device)).total_memory


def check_trainable(cfg: ModelConfig, device, opt_cfg=None,
                    mesh=None) -> None:
    """Raise ``StateTooLarge`` for a config whose training state per
    device under ``mesh`` (``train_state_bytes``; default: the mesh of
    one) exceeds the memory of the card it would train on
    (``card_memory``).  On the CPU nothing is refused."""
    if torch.device(device).type != "cuda":
        return
    mesh = mesh or pick_mesh(1, device)
    need = train_state_bytes(cfg, opt_cfg, mesh)
    capacity = card_memory(device)
    if need > capacity:
        shape = " x ".join(f"{a} {n}" for a, n in mesh.shape.items())
        raise StateTooLarge(
            f"{cfg.name} cannot train on {device}: its training state "
            f"(parameters, gradients and optimizer state) takes {need} "
            f"bytes ({need / 2**30:.1f} GiB) per device on the mesh "
            f"{shape}, more than the card's {capacity} bytes "
            f"({capacity / 2**30:.1f} GiB); train it over more processes "
            f"(torchrun), its smoke config, or on the CPU")


FRONTENDS = ("zeros", "stub")


def batch_tensors(cfg: ModelConfig, batch_np: dict, device,
                  frontend: str = "zeros", step: int = 0) -> dict:
    """A TokenStream batch on ``device``, with an encoder-decoder or VLM
    model's frontend of ``FRONTENDS``: the reference's zeros, or stub
    frames (normal * 0.02 from a generator seeded with ``step``)."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    if cfg.frontend:
        shape = (batch["tokens"].shape[0], cfg.frontend_seq, cfg.d_model)
        if frontend == "zeros":
            fe = torch.zeros(shape, device=device)
        elif frontend == "stub":
            gen = torch.Generator(device).manual_seed(step)
            fe = torch.randn(shape, generator=gen, device=device) * 0.02
        else:
            raise ValueError(f"unknown frontend {frontend!r}; have "
                             f"{FRONTENDS}")
        batch["frontend"] = fe.to(cfg.cdtype)
    return batch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--workdir", default=None,
                    help="checkpoint directory (default: build/train/"
                         "<config> under the checkout)")
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--frontend", default="zeros", choices=FRONTENDS,
                    help="an encoder-decoder or VLM model's frames: the "
                         "reference's zeros, or stub frames (normal * "
                         "0.02) drawn per step")
    return ap.parse_args(argv)


@contextlib.contextmanager
def process_group(device):
    """The run's process group: the one already open, or one opened from
    the environment ``torchrun`` sets (gloo on the CPU, NCCL on CUDA;
    closed on the way out), or none for one process."""
    opened = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        dist.init_process_group("nccl" if torch.device(device).type == "cuda"
                                else "gloo")
        opened = True
    try:
        yield
    finally:
        if opened:
            dist.destroy_process_group()


def rank_device(device) -> torch.device:
    """This process's device: ``device`` resolved, a CUDA rank of a
    process group on card ``LOCAL_RANK`` (made current)."""
    if torch.device(device).type == "cuda" and dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return resolve_device(device)


def init_params(cfg: ModelConfig, gen: torch.Generator, mesh):
    """``lm.init``'s parameters from ``gen``: whole on a mesh of one;
    over a mesh of processes each rank's part (drawn alone,
    ``layers.LocalDraw``) as a ``DTensor`` placed by
    ``param_shardings``."""
    if mesh.dist is None:
        return lm.init(cfg, gen)
    rl, here = rules.logical_rules(mesh), dtensor.coords(mesh)
    region = lambda axes, shape: rules.local_slices(
        rules.spec_for(axes, shape, rl, mesh), shape, mesh, here)
    part = lm.init(cfg, layers.LocalDraw(gen, region))
    shard = rules.param_shardings(lm.param_specs(cfg),
                                  lm.init(cfg, _MetaGenerator()), mesh)
    return layers.as_module(tree_map(
        lambda t, spec: dtensor.distribute(t.detach(), spec, mesh), part,
        shard))


def run(argv=None) -> dict:
    """Train as ``main`` does; returns the losses, each step's wall time
    (ending in the loss's read-back), the steps run, the config and the
    mesh; the trained state is freed on return."""
    args = parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    opt_cfg = optim.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5))
    with process_group(args.device):
        mesh = pick_mesh(device=args.device)
        # before anything is built
        check_trainable(cfg, args.device, opt_cfg, mesh)
        dev = rank_device(args.device)
        if mesh.size > 1:
            mesh = mesh_mod.on_processes(mesh)
        with shctx.use_mesh(mesh):
            return _train(args, cfg, opt_cfg, mesh, dev)


def _train(args, cfg: ModelConfig, opt_cfg, mesh, dev) -> dict:
    rank = dist.get_rank() if mesh.dist is not None else 0
    workdir = args.workdir or WORKDIR / cfg.name
    sup = RunSupervisor(str(workdir), host_id=rank,
                        ckpt_interval=args.ckpt_interval)

    params = init_params(cfg, torch.Generator(dev).manual_seed(0), mesh)
    for p in params.parameters():
        p.requires_grad_(True)
    opt_state = optim.opt_init(params, opt_cfg)

    start_step = 0
    last = ckpt.latest_step(sup.ckpt_dir) if args.resume else None
    if last is not None:
        print(f"[train] resuming from step {last}")
        state = ckpt.restore({"p": params, "o": opt_state, "s": 0}, last,
                             sup.ckpt_dir, device=dev)
        with torch.no_grad():
            tree_map(lambda p, r: dtensor.local(p).copy_(dtensor.local(r)),
                     params, state["p"])
        opt_state, start_step = state["o"], int(state["s"])
        del state

    step_fn = make_train_step(cfg, opt_cfg,
                              TrainFlags(remat=False,
                                         microbatches=args.microbatches),
                              mesh)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch),
                       start_step=start_step)

    losses, step_s = [], []
    for step in range(start_step, args.steps):
        batch = batch_tensors(cfg, next(data), dev, args.frontend, step)
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses.append(loss)
        step_s.append(dt)
        events = sup.after_step(step, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms)"
                  + (f" events={events}" if any(events.values()) else ""))
        if sup.should_checkpoint(step):
            t0 = time.time()
            ckpt.save({"p": params, "o": opt_state, "s": step + 1}, step + 1,
                      sup.ckpt_dir)
            sup.record_ckpt_time(time.time() - t0)
    if losses:
        med = statistics.median(step_s)
        print(f"[train] done: first loss {losses[0]:.4f} "
              f"final loss {losses[-1]:.4f}; median step {med*1e3:.1f} ms, "
              f"{args.batch * args.seq / med:.0f} tokens/s on {dev}, mesh "
              f"{dict(mesh.shape)}")
    return dict(losses=losses, step_s=step_s, start_step=start_step,
                cfg=cfg, args=args, mesh=mesh)


def main(argv=None):
    return run(argv)["losses"]


if __name__ == "__main__":
    main()
