"""MARS-sorted embedding gather (port of ``repro/kernels/mars_gather/ops.py``).

Gathering rows in token order scatters reads over a (vocab x d) table;
MARS-sorting the ids groups the reads by table page, then the inverse
permutation restores order — identical values (see ``ref.py``).  The
sorted rows are copied by ``mars_gather.gather_rows``: the hand-written
Hopper kernel on a CUDA table, its plain twin on a CPU one.

The sorted path is differentiable: when the table needs a gradient it
runs as a ``torch.autograd.Function`` whose backward is
``embedding_grad_scatter`` (the reference's, ``ops.py:50`` there) over
the ids in token order — B2 (``mars_gather.scatter_add_rows``) on CUDA,
its twin on the CPU.  The plain path (tables below 2**22 elements) is
plain autograd.
"""
from __future__ import annotations

import torch

from repro_torch.core.reorder import inverse_permutation
from repro_torch.kernels.mars_gather.mars_gather import (
    gather_rows, scatter_add_rows, scatter_add_rows_plain)
from repro_torch.kernels.mars_gather.ref import embedding_gather_ref

# rows per 4KB-ish HBM "page" bucket used as the MARS grouping key
_PAGE_SHIFT = 2


def _sorted_gather(table, flat):
    """Stable sort by page of row, gather grouped, unsort."""
    perm = torch.argsort(flat >> _PAGE_SHIFT, stable=True)
    gathered = gather_rows(table, flat[perm])
    return gathered[inverse_permutation(perm)]


class _SortedGather(torch.autograd.Function):
    """The sorted gather (K2) with the MARS-sorted scatter (B2) as its
    backward."""

    @staticmethod
    def forward(ctx, table, flat):
        ctx.save_for_backward(flat)
        ctx.vocab = table.shape[0]
        return _sorted_gather(table, flat)

    @staticmethod
    def backward(ctx, grad):
        flat, = ctx.saved_tensors
        return embedding_grad_scatter(flat, grad.contiguous(),
                                      ctx.vocab), None


def embedding_gather(table: torch.Tensor, ids: torch.Tensor,
                     mode: str = "auto") -> torch.Tensor:
    shape = ids.shape
    flat = ids.reshape(-1)
    if mode == "plain" or (mode == "auto" and
                           table.shape[0] * table.shape[1] < (1 << 22)):
        out = embedding_gather_ref(table, flat)
        return out.reshape(*shape, table.shape[1])
    # MARS path: stable sort by page-of-row, gather grouped, unsort
    if torch.is_grad_enabled() and table.requires_grad:
        out = _SortedGather.apply(table, flat)
    else:
        out = _sorted_gather(table, flat)
    return out.reshape(*shape, table.shape[1])


def _sort(ids, grads):
    flat = ids.reshape(-1)
    g = grads.reshape(-1, grads.shape[-1])
    perm = torch.argsort(flat, stable=True)
    return flat[perm].long(), perm, g


def embedding_grad_scatter(ids: torch.Tensor, grads: torch.Tensor,
                           vocab: int) -> torch.Tensor:
    """Backward of the gather: the (vocab, d) table gradient, the rows of
    ``grads`` (..., d) summed at their ``ids`` (...).  The ids are
    stable-sorted by row (as the reference's ``jnp.argsort``), so each
    row's contributions are one contiguous run, summed in f32 in token
    order and rounded once to the grads' dtype (the reference adds in
    that dtype: a deliberate departure, ROADMAP.md §3) — B2 on CUDA
    tensors, its twin on CPU ones."""
    return scatter_add_rows(*_sort(ids, grads), vocab)


def embedding_grad_scatter_plain(ids: torch.Tensor, grads: torch.Tensor,
                                 vocab: int) -> torch.Tensor:
    """``embedding_grad_scatter`` through B2's plain twin on any
    device."""
    return scatter_add_rows_plain(*_sort(ids, grads), vocab)
