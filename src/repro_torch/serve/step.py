"""Serving steps: prefill (build cache) and decode (one token, batched)
(port of ``repro/serve/step.py``).

``make_decode_step`` and ``make_prefill`` work on the concrete dense
``lm.Cache``; ``greedy_generate`` speaks the ``KVBackend`` API
(``kvcache.backend``) and works against any backend.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache: lm.Cache, tokens):
        """tokens: (B, 1) -> (next_token (B, 1), logits, cache) over the
        dense Cache."""
        logits, cache = lm.dense_decode_step(params, cfg, tokens, cache)
        return _greedy(logits), logits, cache
    return serve_step


def make_prefill(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, tokens, frontend=None):
        return lm.dense_prefill(params, cfg, tokens, max_seq=max_seq,
                                frontend_emb=frontend)
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
