"""Optimizers: AdamW (mixed precision, an f32 master copy) and Adafactor
(factored second moment), port of ``repro/optim/adamw.py``.

Plain functions over the port's parameter tree (``layers.as_module`` or
nested dicts) under ``torch.no_grad()``; the states are named tuples with
the reference's field names, their trees nested dicts with the
parameters' keys, so a checkpoint names every leaf as the reference's
does (``o/.step``, ``o/.m/<path>``, ``o/.master/<path>``, ...).  Unlike
the reference's pure functions, an update writes the parameters and the
state's moments and master copy **in place** (no second copy of a 0.5 B
parameter model's 7 GB of state) and returns them with the new step.
The arithmetic is the reference's, leaf by leaf, in float32.

Parameters held as ``DTensor``s over a mesh of processes (the sharded
trainer, ``launch.train``) get a state placed as ``state_shardings``
says (the reference's rule, ``adamw.py:171-194`` there): each moment and
the master copy as its parameter, Adafactor's factored moments with the
trailing axes dropped, scalars replicated.  AdamW updates each rank's
part in place; the clip's norm sums the squares over the shards, and
Adafactor's row and column means and its update clip run on the leaf
gathered whole (the reference's arithmetic on the whole leaf), each rank
keeping its part.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.config import torch_dtype
from repro_torch.sharding import dtensor, rules
from repro_torch.utils.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"  # bfloat16 halves AdamW state memory
    # adafactor
    factored_min: int = 128        # factor 2nd moment for dims >= this


def _step_tensor(step) -> torch.Tensor:
    return step if torch.is_tensor(step) \
        else torch.tensor(step, dtype=torch.int32)


def schedule(cfg: OptConfig, step):
    """Learning rate at ``step`` (an int or int32 tensor): linear warmup,
    then a cosine to 0.1 of ``cfg.lr``; a float32 tensor on step's
    device."""
    step = _step_tensor(step)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cosine)


def _global_norm(tree):
    """The norm over every leaf; a ``DTensor`` leaf's squares summed over
    the mesh axes it is cut on (each replica counted once)."""
    total = 0.0
    for x in leaves(tree):
        sq = torch.sum(torch.square(dtensor.local(x).float()))
        if dtensor.is_dtensor(x):
            mesh = dtensor.mesh_of(x)
            sq = dtensor.all_sum(sq, mesh,
                                 rules.sharded_axes(dtensor.spec_of(x, mesh)))
        total = total + sq
    return torch.sqrt(total)


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any
    master: Any       # fp32 master copy (always present)


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any           # row 2nd-moment factor (full moment if not factored)
    vc: Any           # col factor ((1,) dummy if not factored)
    master: Any


def _factorable(p, cfg: OptConfig) -> bool:
    return (p.dim() >= 2 and p.shape[-1] >= cfg.factored_min
            and p.shape[-2] >= cfg.factored_min)


def _device(params):
    return leaves(params)[0].device


def _master(p):
    return p.detach().float().clone()


def _state_spec(shape, spec) -> tuple:
    """The spec of a state leaf of ``shape`` whose parameter has ``spec``
    (the reference's ``state_shardings``' rule)."""
    if len(shape) == 0 or tuple(shape) == (1,):
        return ()
    if len(spec) == len(shape):
        return tuple(spec)
    if len(spec) > len(shape):          # factored moment: drop trailing axes
        return tuple(spec[:len(shape)])
    return ()


def _zeros(p, shape, dtype):
    """Zeros of ``shape`` for a state leaf of parameter ``p``: placed as
    ``_state_spec`` says where ``p`` is a ``DTensor``."""
    if not dtensor.is_dtensor(p):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    mesh = dtensor.mesh_of(p)
    spec = _state_spec(shape, dtensor.spec_of(p, mesh))
    return dtensor.zeros(shape, spec, mesh, dtype, p.device)


@torch.no_grad()
def adamw_init(params, cfg: OptConfig) -> AdamWState:
    md = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: _zeros(p, p.shape, md)
    return AdamWState(torch.zeros((), dtype=torch.int32,
                                  device=_device(params)),
                      tree_map(zeros, params), tree_map(zeros, params),
                      tree_map(_master, params))


def _clip_scale(grads, cfg: OptConfig):
    gnorm = _global_norm(grads)
    return gnorm, torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptConfig):
    """One AdamW step: writes ``params`` and ``state``'s moments and
    master in place; returns (params, the state with the new step,
    {"grad_norm", "lr"})."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm, scale = _clip_scale(grads, cfg)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device),
                        step.float())
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device),
                        step.float())

    def upd(g, m, v, p, master):
        g = g.float() * scale
        m_n = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_n = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mh = m_n / b1c
        vh = v_n / b2c
        new = master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                             + cfg.weight_decay * master)
        p.copy_(new)
        m.copy_(m_n)
        v.copy_(v_n)
        master.copy_(new)

    tree_map(lambda *ts: upd(*map(dtensor.local, ts)), grads, state.m,
             state.v, params, state.master)
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adafactor_init(params, cfg: OptConfig) -> AdafactorState:
    def vr(p):
        return _zeros(p, p.shape[:-1] if _factorable(p, cfg) else p.shape,
                      torch.float32)

    def vc(p):
        shape = (p.shape[:-2] + p.shape[-1:]) if _factorable(p, cfg) \
            else (1,)
        return _zeros(p, shape, torch.float32)
    return AdafactorState(torch.zeros((), dtype=torch.int32,
                                      device=_device(params)),
                          tree_map(vr, params), tree_map(vc, params),
                          tree_map(_master, params))


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, cfg: OptConfig):
    """One Adafactor step, in place as ``adamw_update``."""
    step = state.step + 1
    lr = schedule(cfg, step)
    gnorm, scale = _clip_scale(grads, cfg)
    decay = 1.0 - step.float() ** -0.8

    def upd(g, vr, vc, p, master):
        g = g.float() * scale
        g2 = g * g + 1e-30
        if _factorable(p, cfg):
            vr_n = decay * vr + (1 - decay) * g2.mean(-1)
            vc_n = decay * vc + (1 - decay) * g2.mean(-2)
            denom = (vr_n[..., None] * vc_n[..., None, :]
                     / torch.clamp_min(vr_n.mean(-1, keepdim=True)[..., None],
                                       1e-30))
            u = g * torch.rsqrt(denom + 1e-30)
        else:
            vr_n = decay * vr + (1 - decay) * g2
            vc_n = vc
            u = g * torch.rsqrt(vr_n + 1e-30)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)   # update clipping
        u = u / torch.clamp_min(rms, 1.0)
        new = master - lr * (u + cfg.weight_decay * master)
        return new, vr_n, vc_n

    def leaf(g, vr, vc, p, master):
        if not dtensor.is_dtensor(p):
            new, vr_n, vc_n = upd(g, vr, vc, p, master)
            for t, v in ((p, new), (vr, vr_n), (vc, vc_n), (master, new)):
                t.copy_(v)
            return
        # the means and the update clip span the whole leaf
        mesh = dtensor.mesh_of(p)
        new, vr_n, vc_n = upd(g.full_tensor(), vr.full_tensor(),
                              vc.full_tensor(), p, master.full_tensor())
        for t, v in ((p, new), (vr, vr_n), (vc, vc_n), (master, new)):
            dtensor.local(t).copy_(dtensor.local_part(
                v, dtensor.spec_of(t, mesh), mesh))

    tree_map(leaf, grads, state.vr, state.vc, params, state.master)
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}


def opt_init(params, cfg: OptConfig):
    return adamw_init(params, cfg) if cfg.kind == "adamw" \
        else adafactor_init(params, cfg)


def opt_update(grads, state, params, cfg: OptConfig):
    return adamw_update(grads, state, params, cfg) if cfg.kind == "adamw" \
        else adafactor_update(grads, state, params, cfg)


def state_shardings(state, param_shardings, mesh):
    """The specs of an optimizer state (a tree of tensors; meta ones
    too) whose parameters have ``param_shardings``: each leaf as its
    parameter, a factored moment with the trailing axes dropped, scalars
    and the (1,) placeholders replicated (reference ``adamw.py:171``)."""
    def map_like(leaf_tree):
        return tree_map(lambda s, spec: _state_spec(s.shape, spec),
                        leaf_tree, param_shardings)
    if isinstance(state, AdamWState):
        return AdamWState((), map_like(state.m), map_like(state.v),
                          map_like(state.master))
    return AdafactorState((), map_like(state.vr), map_like(state.vc),
                          map_like(state.master))
