"""Plain oracle for blockwise attention (port of
``repro/kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D), k, v: (B, Sk, H, D) -> (B, S, H, D); f32 softmax.
    Causal queries sit at the tail of the keys (offset ``Sk - S``);
    ``window`` > 0 keeps the last ``window`` keys of each query."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    S, Sk = q.shape[1], k.shape[1]
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (Sk - S)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        m = kpos <= qpos
        if window:
            m &= kpos > qpos - window
        logits = torch.where(m, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
