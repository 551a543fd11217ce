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
K2 (the sorted embedding gather) and K3 (the SSM layers' chunked scan),
whose gradients are the kernels B5, B2 and B3.  A kernel wrapper that
would run outside autograd raises: K4's, which has no backward kernel
yet, and K5 at a head dim B5 does not take.  ``check_trainable`` refuses
the MoE families on CUDA before anything is built.  There is no quiet
switch to the plain twins; on the CPU every family trains through them.

Checkpoints go to ``--workdir``, by default ``build/train/<config>``
under the checkout (git-ignored; the config's name tells a smoke run
from a full-width one), so ``--resume`` finds only the same config's.

The reference's ``pick_mesh`` and its parameter shardings place the
state on a JAX mesh of many devices; one card has no counterpart, and
they wait for the sharding rules of the XLA-tooling slice (ROADMAP.md
§1).
"""
from __future__ import annotations

import argparse
import statistics
import time
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.manager import RunSupervisor
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as optim
from repro_torch.train.step import TrainFlags, make_train_step
from repro_torch.utils.tree import tree_map

NO_BACKWARD = ("nor does the port have the parameter sharding rules "
               "that spread the experts over several cards")
WORKDIR = Path(__file__).resolve().parents[3] / "build" / "train"


def check_trainable(cfg: ModelConfig, device) -> None:
    """Raise for a config whose CUDA training forward would launch K4,
    which has no backward kernel (its wrapper raises too, but only once
    the model is built and a batch is on the card)."""
    if torch.device(device).type != "cuda":
        return
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name} cannot train on CUDA yet: its forward launches K4 "
            f"grouped_matmul (MoE layers), which has no backward kernel B4 "
            f"({NO_BACKWARD}); train it with --device cpu")


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


def run(argv=None) -> dict:
    """Train as ``main`` does; returns the losses, each step's wall time
    (ending in the loss's read-back), the steps run and the config."""
    args = parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    check_trainable(cfg, args.device)       # before anything is built
    dev = resolve_device(args.device)
    opt_cfg = optim.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5))
    workdir = args.workdir or WORKDIR / cfg.name
    sup = RunSupervisor(str(workdir), ckpt_interval=args.ckpt_interval)

    params = lm.init(cfg, torch.Generator(dev).manual_seed(0))
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
            tree_map(lambda p, r: p.copy_(r), params, state["p"])
        opt_state, start_step = state["o"], int(state["s"])
        del state

    step_fn = make_train_step(cfg, opt_cfg,
                              TrainFlags(remat=False,
                                         microbatches=args.microbatches))
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
              f"{args.batch * args.seq / med:.0f} tokens/s on {dev}")
    return dict(losses=losses, step_s=step_s, start_step=start_step,
                cfg=cfg, args=args)


def main(argv=None):
    return run(argv)["losses"]


if __name__ == "__main__":
    main()
