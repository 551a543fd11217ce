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
the data axes) and fetches each parameter's arithmetic cut
(``rules.model_cut``, ``dtensor.fetch``): whole over the data axes, and
over ``model`` its query heads and the KV heads they read, its MLP
hidden units, its vocabulary rows, its SSM heads and its experts, the
rest whole.  The layers then run tensor-parallel (``dtensor.model_rank``):
column-parallel products take an input whose gradient is summed over
``model``, row-parallel ones sum their outputs over it, and the loss is
a vocabulary-parallel cross-entropy.  Each rank's objective is its
share of the global loss: its summed token losses over the global
count of labelled tokens, plus its share of the router losses (which
the MoE layer reduces over the data shards itself), so the objectives
of a model row's ranks are one and the data rows' add up to the global
mean.  Each cut's gradient goes back by the transpose
(``dtensor.return_grad``): summed over the data axes and over the model
ranks that computed parts of it, then cut to the parameter's placement.
"""
from __future__ import annotations

import dataclasses

import torch

import math

from repro_torch.models import lm
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


def model_cuts(cfg: ModelConfig, mesh, params) -> dict:
    """Each parameter's arithmetic cuts on ``mesh``: a tuple of
    ``rules.model_cut`` of its logical axes on every model rank, in rank
    order (what ``dtensor.fetch`` and ``dtensor.return_grad`` exchange),
    as nested dicts."""
    n = mesh.shape.get("model", 1)
    specs = lm.param_specs(cfg)
    return _map_paths(lambda name, p: tuple(rules.model_cut(
        _at(specs, name), tuple(p.shape), cfg, n, r) for r in range(n)),
        params)


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
    losses, the gradients of the leaves' cuts), before they go back to
    the leaves' placements (``_place_grads``).  An empty cut (a rank
    with no heads) gets an empty gradient; any other leaf the loss does
    not reach is an error."""
    daxes = shctx.data_axes(mesh)
    n_data = math.prod(mesh.shape[a] for a in daxes)

    def grads_of(params, tokens, labels, frontend):
        cuts = model_cuts(cfg, mesh, params)
        work = _map_paths(lambda name, p: dtensor.fetch(
            p, mesh, _at(cuts, name)).requires_grad_(), params)
        with shctx.use_mesh(mesh):
            nll, count, aux = lm.loss_terms(work, cfg, tokens, labels,
                                            frontend, remat=flags.remat)
        count = dtensor.all_sum(count, mesh, daxes)
        obj = nll / torch.clamp_min(count, 1) + flags.aux_weight * (
            aux["moe_lb"] + 1e-3 * aux["moe_z"]) / n_data
        ws = [w for w in leaves(work) if w.numel()]
        by_id = dict(zip(map(id, ws), torch.autograd.grad(obj, ws)))
        loss = dtensor.all_sum(obj.detach(), mesh, daxes)
        return loss, aux, tree_map(
            lambda w: by_id[id(w)] if w.numel() else torch.zeros_like(w),
            work)
    return grads_of


def _place_grads(cfg: ModelConfig, mesh, params, grads):
    """The cuts' gradients returned to their parameters' placements
    (``dtensor.return_grad``, ``DTensor``s)."""
    daxes = shctx.data_axes(mesh)
    cuts = model_cuts(cfg, mesh, params)
    return _map_paths(lambda name, p: dtensor.return_grad(
        _at(grads, name), p, mesh, _at(cuts, name), daxes), params)


def _at(tree, name: str):
    for part in name.split("/"):
        tree = tree[part]
    return tree
