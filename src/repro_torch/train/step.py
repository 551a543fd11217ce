"""Train step: loss -> grads -> optimizer, with optional microbatch
gradient accumulation and activation rematerialization (port of
``repro/train/step.py``).

The reference's step is a pure function that ``jax.value_and_grad``
differentiates and ``pjit`` places; here autograd takes the gradients
(through K5/B5 and K2/B2 on the card, their plain twins on the CPU) and
the optimizer writes the parameters and its state in place
(``optim.adamw``).  The reference's microbatch ``lax.scan`` is a loop
that accumulates the gradients in f32 before one optimizer update.

Over a mesh of processes (``launch.mesh.Mesh`` with ``dist``; the
parameters are ``DTensor``s placed by ``sharding.rules``) each rank
takes its rows of the global batch (``rules.batch_sharding``: split over
the data axes), gathers every parameter whole (``sharding.dtensor``)
but the MoE experts, which stay cut over ``model`` for the
expert-parallel dispatch, and runs the model on plain tensors.  Each
rank's objective is its share of the global loss: its summed token
losses over the global count of labelled tokens, plus its share of the
router losses (which the MoE layer reduces over the data shards
itself), so the ranks' objectives add up to the global mean.  The
gradients are summed over the data axes and cut back to each
parameter's placement (``dtensor.reduce_grad``).  Every model rank of a
data row repeats that row's dense arithmetic: the model axis cuts
storage and the experts, not the heads' or the MLP's products.
"""
from __future__ import annotations

import dataclasses

import torch

import math

from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as optim
from repro_torch.sharding import context as shctx
from repro_torch.sharding import dtensor, rules
from repro_torch.utils.tree import children, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainFlags:
    remat: bool = True
    microbatches: int = 1          # gradient-accumulation steps
    aux_weight: float = 0.01


def make_loss(cfg: ModelConfig, flags: TrainFlags):
    def loss(params, tokens, labels, frontend):
        return lm.loss_fn(params, cfg, tokens, labels, frontend,
                          remat=flags.remat, aux_weight=flags.aux_weight)
    return loss


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(name, leaf)`` over a parameter tree's leaves, as nested dicts
    (names as ``utils.tree.leaf_paths`` gives them)."""
    kids = children(tree)
    if kids is None:
        return fn(prefix, tree)
    return {n: _map_paths(fn, c, f"{prefix}/{n}" if prefix else n)
            for n, c in kids}


def kept_axes(cfg: ModelConfig, mesh, name: str) -> tuple:
    """The mesh axes a parameter stays cut over when the layers read it:
    ``("model",)`` for an MoE layer's expert weights under the
    expert-parallel dispatch, else none (gathered whole)."""
    parts = name.split("/")
    if moe_mod.expert_parallel(cfg, mesh) and len(parts) > 1 \
            and parts[-2] == "moe" and parts[-1] in moe_mod.EXPERT_LEAVES:
        return ("model",)
    return ()


def local_rows(mesh, batch: int) -> slice:
    """This rank's rows of a global batch split over the data axes."""
    daxes = shctx.data_axes(mesh)
    n = math.prod(mesh.shape[a] for a in daxes)
    if batch % n:
        raise ValueError(f"a global batch of {batch} does not split over "
                         f"the mesh's data axes {daxes} ({n} shards)")
    (lo, hi), = rules.local_slices(rules.batch_sharding(mesh, batch),
                                   (batch,), mesh, dtensor.coords(mesh))
    return slice(lo, hi)


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    flags: TrainFlags = TrainFlags(), mesh=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    batch: {"tokens": (B,S), "labels": (B,S), "frontend": optional}.
    Every parameter must require a gradient.  With flags.microbatches >
    1 the batch's leading axis is split and gradients are accumulated in
    fp32 before one optimizer update (peak activation memory ~1/k at the
    cost of k sequential passes).  metrics: "loss" (a float32 tensor),
    "grad_norm", "lr".

    ``mesh``: a mesh over processes (``Mesh.dist`` set), whose ranks each
    take the batch whole and train on their rows of it; the loss is the
    global one and the gradients come back as ``DTensor``s."""
    loss_fn = make_loss(cfg, flags)
    spread = mesh is not None and mesh.dist is not None

    def grads_of(params, tokens, labels, frontend):
        ps = leaves(params)
        loss, aux = loss_fn(params, tokens, labels, frontend)
        by_id = dict(zip(map(id, ps), torch.autograd.grad(loss, ps)))
        return loss.detach(), aux, tree_map(lambda p: by_id[id(p)], params)

    if spread:
        grads_of = _sharded_grads(cfg, flags, mesh)

    def step(params, opt_state, batch):
        tokens = batch["tokens"]
        labels = batch["labels"]
        frontend = batch.get("frontend")
        if spread:
            rows = local_rows(mesh, tokens.shape[0])
            tokens, labels = tokens[rows], labels[rows]
            frontend = None if frontend is None else frontend[rows]
        k = flags.microbatches
        if k > 1:
            mb = tokens.shape[0] // k
            g = lsum = None
            for i in range(k):
                rows = slice(i * mb, (i + 1) * mb)
                loss, _, gi = grads_of(
                    params, tokens[rows], labels[rows],
                    None if frontend is None else frontend[rows])
                if g is None:
                    g, lsum = tree_map(lambda x: x.float(), gi), loss
                else:
                    tree_map(lambda a, x: a.add_(x.float()), g, gi)
                    lsum = lsum + loss
                del gi
            g = tree_map(lambda a: a.div_(k), g)
            loss = lsum / k
        else:
            loss, _, g = grads_of(params, tokens, labels, frontend)
        if spread:
            g = _place_grads(cfg, mesh, params, g)

        params, opt_state, om = optim.opt_update(g, opt_state, params,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return step


def _sharded_grads(cfg: ModelConfig, flags: TrainFlags, mesh):
    """``grads_of`` for a rank of ``mesh``: (the global loss, the router
    losses, the gradients of the gathered leaves), before they are summed
    over the data axes (``_place_grads``)."""
    daxes = shctx.data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in daxes)

    def grads_of(params, tokens, labels, frontend):
        work = _map_paths(lambda name, p: dtensor.gather(
            p, mesh, kept_axes(cfg, mesh, name)).requires_grad_(), params)
        with shctx.use_mesh(mesh):
            nll, count, aux = lm.loss_terms(work, cfg, tokens, labels,
                                            frontend, remat=flags.remat)
        count = dtensor.all_sum(count, mesh, daxes)
        obj = nll / torch.clamp_min(count, 1) + flags.aux_weight * (
            aux["moe_lb"] + 1e-3 * aux["moe_z"]) / n_data
        ws = leaves(work)
        by_id = dict(zip(map(id, ws), torch.autograd.grad(obj, ws)))
        loss = dtensor.all_sum(obj.detach(), mesh, daxes)
        return loss, aux, tree_map(lambda w: by_id[id(w)], work)
    return grads_of


def _place_grads(cfg: ModelConfig, mesh, params, grads):
    """The gathered leaves' gradients summed over the data axes and cut
    to their parameters' placements (``DTensor``s)."""
    daxes = shctx.data_axes(mesh)

    def one(name, p):
        g = _at(grads, name)
        return dtensor.reduce_grad(g, dtensor.spec_of(p, mesh), mesh, daxes,
                                   kept_axes(cfg, mesh, name))
    return _map_paths(one, params)


def _at(tree, name: str):
    for part in name.split("/"):
        tree = tree[part]
    return tree
