"""Plain oracle for paged-KV decode attention (port of
``repro/kernels/paged_attention/ref.py``).

Cache layout: KV lives in fixed-size pages; each sequence owns a list of
page ids (its "page table").  One decode step attends one query token per
sequence over its first ``length`` cached positions.

``paged_attention_ref`` mirrors the kernel (cached positions only);
``paged_decode_ref`` is the full decode-step oracle: cached positions
*plus* the in-flight token's K/V with one plain softmax over the
concatenated keys — what ``paged_attention.decode_attend`` must match.
Both accept 4-D pages or a layered 5-D pool buffer with ``layer``, and a
``window`` > 0 sliding-window restriction.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _layer_plane(k_pages, v_pages, layer):
    if k_pages.dim() == 5:
        return k_pages[layer], v_pages[layer]
    return k_pages, v_pages


def _window_lo(ln, window):
    """First valid cached position for a query at position ``ln``."""
    return ln - int(window) + 1 if int(window) > 0 else torch.zeros_like(ln)


def _gather(pages, page_tables):
    """(P, page, Hkv, D) pages + (B, n) table -> (B, n * page, Hkv, D)."""
    B = page_tables.shape[0]
    return pages[page_tables.long()].reshape(B, -1, *pages.shape[2:])


def paged_attention_ref(q, k_pages, v_pages, page_tables, lengths,
                        layer=0, window=0):
    """q: (B, H, D); k_pages/v_pages: (P, page, Hkv, D) or layered
    (L, P, page, Hkv, D); page_tables: int (B, n_pages); lengths: int (B,).
    Returns (B, H, D).  GQA via H % Hkv == 0 head repetition."""
    B, H, D = q.shape
    k_pages, v_pages = _layer_plane(k_pages, v_pages, layer)
    n_rep = H // k_pages.shape[2]
    k = _gather(k_pages, page_tables).repeat_interleave(n_rep, dim=2)
    v = _gather(v_pages, page_tables).repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q, k).float() * (1.0 / math.sqrt(D))
    pos = torch.arange(k.shape[1], device=q.device)[None, :]
    ln = lengths.long()[:, None]
    mask = (pos < ln) & (pos >= _window_lo(ln, window))
    s = torch.where(mask[:, None, :], s, torch.tensor(NEG_INF,
                                                      device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", w.to(q.dtype), v)


def paged_decode_ref(q, k_new, v_new, k_pages, v_pages, page_tables,
                     lengths, layer=0, window=0):
    """Decode-step oracle: attend the cached pages AND the in-flight
    token (k_new/v_new: (B, Hkv, D)) with one flat softmax; ``window``
    > 0 restricts the cached positions (the in-flight token is always
    attended).  Returns (B, H, D)."""
    B, H, D = q.shape
    k_pages, v_pages = _layer_plane(k_pages, v_pages, layer)
    n_rep = H // k_pages.shape[2]
    k = torch.cat([_gather(k_pages, page_tables), k_new[:, None]], dim=1)
    v = torch.cat([_gather(v_pages, page_tables), v_new[:, None]], dim=1)
    k = k.repeat_interleave(n_rep, dim=2).float()
    v = v.repeat_interleave(n_rep, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * (1.0 / math.sqrt(D))
    S = k.shape[1]
    pos = torch.arange(S, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    mask = ((pos < ln) & (pos >= _window_lo(ln, window))) | (pos == S - 1)
    s = torch.where(mask[:, None, :], s, torch.tensor(NEG_INF,
                                                      device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", w, v).to(q.dtype)
