"""Plain oracles for the MARS-sorted grouped matmul (port of
``repro/kernels/moe_dispatch/ref.py``).

Contract: ``grouped_matmul(x, w, group_sizes)`` where
  x: (M, K)  rows sorted by group (MARS page order)
  w: (G, K, N) per-group weights
  group_sizes: int (G,), sum <= M (trailing rows belong to the last group
  with zero semantic weight — callers zero them)

out[i] = x[i] @ w[g(i)]  with g(i) the group containing row i.
"""
from __future__ import annotations

import numpy as np
import torch


def grouped_matmul_ref(x, w, group_sizes):
    """torch oracle: gathers one (K, N) matrix per row — O(M*K*N) memory,
    for tests and small shapes only."""
    M = x.shape[0]
    G = w.shape[0]
    ends = torch.cumsum(torch.as_tensor(group_sizes, device=x.device), 0)
    gid = torch.searchsorted(ends, torch.arange(M, device=x.device),
                             right=True)
    gid = torch.clamp_max(gid, G - 1)
    return torch.einsum("mk,mkn->mn", x, w[gid])


def grouped_matmul_ref_loop(x, w, group_sizes):
    """Second independent oracle (numpy loop) for small tests."""
    x = np.asarray(x, np.float32)
    w = np.asarray(w, np.float32)
    gs = np.asarray(group_sizes)
    out = np.zeros((x.shape[0], w.shape[2]), np.float32)
    r = 0
    for g, n in enumerate(gs):
        out[r:r + n] = x[r:r + n] @ w[g]
        r += n
    if r < x.shape[0]:
        out[r:] = x[r:] @ w[-1]
    return out
