"""Train step: loss -> grads -> optimizer, with optional microbatch
gradient accumulation and activation rematerialization (port of
``repro/train/step.py``).

The reference's step is a pure function that ``jax.value_and_grad``
differentiates and ``pjit`` places; here autograd takes the gradients
(through K5/B5 and K2/B2 on the card, their plain twins on the CPU) and
the optimizer writes the parameters and its state in place
(``optim.adamw``).  The reference's microbatch ``lax.scan`` is a loop
that accumulates the gradients in f32 before one optimizer update.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as optim
from repro_torch.utils.tree import leaves, tree_map


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


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    flags: TrainFlags = TrainFlags()):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    batch: {"tokens": (B,S), "labels": (B,S), "frontend": optional}.
    Every parameter must require a gradient.  With flags.microbatches >
    1 the batch's leading axis is split and gradients are accumulated in
    fp32 before one optimizer update (peak activation memory ~1/k at the
    cost of k sequential passes).  metrics: "loss" (a float32 tensor),
    "grad_norm", "lr"."""
    loss_fn = make_loss(cfg, flags)

    def grads_of(params, tokens, labels, frontend):
        ps = leaves(params)
        loss, aux = loss_fn(params, tokens, labels, frontend)
        by_id = dict(zip(map(id, ps), torch.autograd.grad(loss, ps)))
        return loss.detach(), aux, tree_map(lambda p: by_id[id(p)], params)

    def step(params, opt_state, batch):
        tokens = batch["tokens"]
        labels = batch["labels"]
        frontend = batch.get("frontend")
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

        params, opt_state, om = optim.opt_update(g, opt_state, params,
                                                 opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return step
