"""Serving steps: prefill (build cache) and decode (one token, batched)
(port of ``repro/serve/step.py``).

``make_decode_step`` and ``make_prefill`` work on the concrete dense
``lm.Cache``; ``greedy_generate`` speaks the ``KVBackend`` API
(``kvcache.backend``) and works against any backend.

Given a mesh over processes (``launch.mesh.on_processes``) the two
steps run tensor-parallel, as the reference's serve cells are sharded:
the parameters are ``DTensor``s placed by ``rules.param_shardings`` at
``fsdp=False`` (``place``), this rank's arithmetic cut of them is
fetched once (``cut_params``, ``dtensor.fetch``) and every step reads
it, so a step's collectives are the activations' alone; the cache is this rank's part under
``rules.cache_shardings`` (cut by KV heads, or by sequence where they do
not divide the model axis), a data row serves its rows of the batch
where the batch divides the data axes, and the logits come back whole.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def place(cfg: ModelConfig, params, mesh):
    """Whole parameters as ``DTensor``s on ``mesh``, placed as a serve
    cell places them (``rules.param_shardings`` at ``fsdp=False``)."""
    from repro_torch.models import layers
    from repro_torch.sharding import dtensor, rules
    from repro_torch.utils.tree import tree_map
    shard = rules.param_shardings(lm.param_specs(cfg), params, mesh,
                                  fsdp=False)
    return layers.as_module(tree_map(
        lambda t, spec: dtensor.distribute(
            dtensor.local_part(t.detach(), spec, mesh), spec, mesh),
        params, shard))


def serve_rows(mesh, batch: int) -> slice:
    """The rows of a global batch a data row of ``mesh`` serves: its
    block where the batch divides the data axes (the cache's batch spec,
    ``rules.cache_shardings``), else all of them."""
    from repro_torch.sharding import context as shctx
    from repro_torch.train import step as train_step
    daxes = shctx.data_axes(mesh)
    if batch % math.prod(mesh.shape[a] for a in daxes):
        return slice(0, batch)
    return train_step.local_rows(mesh, batch)


def cut_params(cfg: ModelConfig, mesh, params):
    """This rank's arithmetic cut of every parameter (``dtensor.fetch``),
    detached: what the steps over ``mesh`` take, fetched once for a
    placement."""
    from repro_torch.sharding import dtensor
    from repro_torch.train import step as train_step
    cuts = train_step.model_cuts(cfg, mesh, params)
    return train_step._map_paths(lambda name, p: dtensor.fetch(
        p, mesh, train_step._at(cuts, name)), params)


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, cache, tokens)``: tokens (B, 1) -> (next_token
    (B, 1), logits, cache) over the dense Cache; over ``mesh`` (a mesh
    of processes) tensor-parallel on this rank's parameter cuts
    (``cut_params``), rows (``serve_rows``) and cache part."""
    def serve_step(params, cache: lm.Cache, tokens):
        if mesh is None:
            logits, cache = lm.dense_decode_step(params, cfg, tokens, cache)
            return _greedy(logits), logits, cache
        from repro_torch.sharding import context as shctx
        tokens = tokens[serve_rows(mesh, tokens.shape[0])]
        with shctx.use_mesh(mesh), torch.no_grad():
            logits, cache = lm.dense_decode_step(params, cfg, tokens, cache)
        return _greedy(logits), logits, cache
    return serve_step


def make_prefill(cfg: ModelConfig, max_seq: int, mesh=None):
    """``prefill_step(params, tokens, frontend)`` -> (last logits, dense
    Cache sized ``max_seq``); over ``mesh`` tensor-parallel on this
    rank's parameter cuts (``cut_params``), returning its rows' logits
    and its part of the cache."""
    def prefill_step(params, tokens, frontend=None):
        if mesh is None:
            return lm.dense_prefill(params, cfg, tokens, max_seq=max_seq,
                                    frontend_emb=frontend)
        from repro_torch.sharding import context as shctx
        rows = serve_rows(mesh, tokens.shape[0])
        with shctx.use_mesh(mesh), torch.no_grad():
            return lm.dense_prefill(
                params, cfg, tokens[rows], max_seq=max_seq,
                frontend_emb=None if frontend is None else frontend[rows])
    return prefill_step


def greedy_generate(params, cfg: ModelConfig, prompt, n_tokens: int,
                    max_seq: int = 0, frontend=None, backend=None):
    """Reference generation loop: prefill ``prompt`` (B, S), then greedy
    decode; returns the (B, n_tokens) int32 tokens on the prompt's
    device, the first from the prefill.

    Runs through the ``KVBackend`` API: dense by default (``max_seq``),
    or any backend passed in (e.g. a ``PagedBackend``) — the generated
    tokens must not depend on which backend holds the KV.  ``frontend``
    (B, Senc, d) feeds an encoder-decoder model's encoder.
    """
    logits, backend = lm.prefill(params, cfg, prompt, max_seq=max_seq,
                                 frontend_emb=frontend, backend=backend)
    tok = _greedy(logits)
    out = [tok]
    for _ in range(n_tokens - 1):
        logits, backend = lm.decode_step(params, cfg, tok, backend)
        tok = _greedy(logits)
        out.append(tok)
    return torch.cat(out, dim=1).to(prompt.device)
