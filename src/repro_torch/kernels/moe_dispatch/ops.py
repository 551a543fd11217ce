"""Public MoE-dispatch op: MARS sort + group padding + grouped matmul
(port of ``repro/kernels/moe_dispatch/ops.py``).

``mars_moe_ffn(x, expert_idx, gates, w_in, w_gate, w_out)`` runs a full
expert FFN over top-k routed tokens:

  1. flatten (token, k) assignments, MARS-sort by expert id ("page")
  2. pad each expert's segment to the M-tile so row tiles are single-expert
  3. grouped matmuls (``grouped_matmul``: the Hopper kernel on CUDA
     tensors) — or, without ``use_kernel``, the plain grouped product
  4. inverse-permute + gate-weighted combine

Everything stays on the tensors' device: counts, offsets, slots, the
tile -> group map and the number of tiles in use are tensors, never read
back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.reorder import group_offsets, inverse_permutation
from repro_torch.kernels.moe_dispatch.moe_dispatch import (DEFAULT_BM,
                                                           grouped_matmul)
from repro_torch.kernels.moe_dispatch.ref import grouped_matmul_ref
from repro_torch.models import layers


def tight_rows(n_assign: int, n_groups: int, bm: int) -> int:
    """Rows that always hold ``n_assign`` sorted assignments padded group
    by group to ``bm``: at most ``min(n_groups, n_assign)`` groups are
    non-empty and each adds at most ``bm - 1`` padding rows, and the
    padded total is a multiple of ``bm`` — so the bound rounds down.  It
    never exceeds the reference's ``n_assign + n_groups * bm``."""
    rows = n_assign + min(n_groups, n_assign) * (bm - 1)
    return rows // bm * bm


def pad_sorted_groups(sorted_e, perm, n_groups: int, bm: int, *,
                      tight: bool = False):
    """Padded slot of each sorted assignment + tile -> group map.

    Each group's segment starts at a bm-aligned offset; rows inside a
    padded segment not backed by a real assignment stay zero.  Returns
    ``(slot (A,) int32, tile_group (M_pad // bm,) int32, M_pad, n_used)``:
    ``M_pad`` is the reference's static bound ``A + n_groups * bm``, or
    with ``tight`` the bound ``tight_rows`` (every tile the reference
    adds past it is empty); ``n_used``, a one-element int32 tensor, is
    the number of tiles the padded groups fill.  ``perm`` is unused, as
    in the reference."""
    del perm
    A = sorted_e.shape[0]
    dev = sorted_e.device
    e = sorted_e.long()
    seg = group_offsets(sorted_e, n_groups)
    counts = seg[1:] - seg[:-1]
    padded = (counts + bm - 1) // bm * bm
    bounds = torch.cumsum(padded, 0, dtype=torch.int32)
    starts = bounds - padded
    slot = starts[e] + (torch.arange(A, dtype=torch.int32, device=dev)
                        - seg[:-1][e])
    M_pad = tight_rows(A, n_groups, bm) if tight else A + n_groups * bm
    tile_starts = torch.arange(M_pad // bm, dtype=torch.int32,
                               device=dev) * bm
    tile_group = torch.searchsorted(bounds, tile_starts, right=True,
                                    out_int32=True)
    tile_group = torch.clamp_max(tile_group, n_groups - 1)
    n_used = (bounds[-1:] // bm).to(torch.int32)
    return slot, tile_group, M_pad, n_used


class _TakeRows(torch.autograd.Function):
    """``x[rows]`` for distinct ``rows``, whose backward writes each
    incoming row once into zeros (``index_copy_``).  Autograd of the
    index would accumulate them by an ``index_put_``, which on CUDA
    sorts the indices first."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.save_for_backward(rows)
        ctx.n = x.shape[0]
        return x[rows]

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        return g.new_zeros((ctx.n,) + g.shape[1:]).index_copy_(0, rows, g), \
            None


def grouped_ffn_padded(tokens, sorted_e, w_in, w_gate, w_out, *,
                       n_groups: int, act: str, bm: int):
    """Expert FFN over MARS-sorted rows ``tokens`` (A, d) of experts
    ``sorted_e`` (A,): pad the groups to ``bm`` (tight bound), run the
    three products through ``grouped_matmul`` with ``act(g) * h`` between
    them, and return the (A, d) rows in the same sorted order."""
    slot, tile_group, M_pad, n_used = pad_sorted_groups(
        sorted_e, None, n_groups, bm, tight=True)
    slot = slot.long()
    xbuf = tokens.new_zeros((M_pad, tokens.shape[1]))
    xbuf.index_copy_(0, slot, tokens)
    h = grouped_matmul(xbuf, w_in, tile_group, bm=bm, n_tiles=n_used)
    g = grouped_matmul(xbuf, w_gate, tile_group, bm=bm, n_tiles=n_used)
    h = layers._act(g, act) * h
    out = grouped_matmul(h, w_out, tile_group, bm=bm, n_tiles=n_used)
    return _TakeRows.apply(out, slot)


def mars_moe_ffn(x, expert_idx, gates, w_in, w_gate, w_out, *,
                 n_experts: int, act: str = "silu", bm: int = DEFAULT_BM,
                 use_kernel: bool = False):
    """x: (T, d); expert_idx: (T, k); gates: (T, k); w_*: (E, d, f) /
    (E, f, d).  Returns (T, d).

    ``use_kernel`` pads the sorted groups and runs the three products
    through ``grouped_matmul`` (the counterpart of the reference's
    ``use_pallas=True``); otherwise the plain grouped product over the
    unpadded groups (the reference's ``ragged_dot`` route).  The k
    weighted expert outputs of a token are summed in a fixed order."""
    T, d = x.shape
    k = expert_idx.shape[1]
    flat_e = expert_idx.reshape(-1).to(torch.int32)
    perm = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[perm]
    gathered = x[perm // k]                             # (A, d) MARS order
    if use_kernel:
        out_sorted = grouped_ffn_padded(gathered, sorted_e, w_in, w_gate,
                                        w_out, n_groups=n_experts, act=act,
                                        bm=bm)
    else:
        seg = group_offsets(sorted_e, n_experts)
        sizes = seg[1:] - seg[:-1]
        h = grouped_matmul_ref(gathered, w_in, sizes)
        g = grouped_matmul_ref(gathered, w_gate, sizes)
        h = layers._act(g, act) * h
        out_sorted = grouped_matmul_ref(h, w_out, sizes)
    out_flat = out_sorted[inverse_permutation(perm)]
    w = gates.reshape(-1, 1).to(out_flat.dtype)
    return (out_flat * w).view(T, k, d).sum(1).to(x.dtype)
