"""Bulk MARS reorder (port of ``repro/core/reorder.py``).

Within a bounded window of requests (tokens / indices / KV-page reads),
emit requests grouped by destination page, pages ordered by first
arrival, FIFO within a page: a stable argsort by
``first_arrival[page_of(i)]``.  Host-side consumers (lane ordering,
sorted gathers) call it on small index arrays, so numpy suffices; the
permutation is the reference's, element for element.  The MoE
dispatch sorts its token->expert assignments inside every layer, so
``mars_sort_by_page`` and ``group_offsets`` work on torch tensors on
their own device.
"""
from __future__ import annotations

import numpy as np
import torch


def mars_order(page_ids, *, num_pages: int | None = None,
               window: int | None = None) -> np.ndarray:
    """Return the MARS emission permutation (int32) for a stream of page
    ids: ``page_ids[perm]`` is grouped by page, pages in first-arrival
    order, FIFO within a page.  With ``window`` set the stream is
    processed in independent windows of that size.  ``num_pages`` is
    accepted for signature parity; the result does not depend on it."""
    page_ids = np.asarray(page_ids)
    n = page_ids.shape[0]
    if n == 0:
        return np.zeros(0, np.int32)
    if window is not None and window < n:
        pad = (-n) % window
        padded = np.concatenate(
            [page_ids, np.full(pad, np.iinfo(np.int32).max, page_ids.dtype)])
        rows = padded.reshape(-1, window)
        out = np.concatenate([_mars_order_full(r) + i * window
                              for i, r in enumerate(rows)])
        return out[:n].astype(np.int32)
    return _mars_order_full(page_ids)


def _mars_order_full(page_ids: np.ndarray) -> np.ndarray:
    _, first, inv = np.unique(page_ids, return_index=True,
                              return_inverse=True)
    key = first[inv.reshape(-1)]
    return np.argsort(key, kind="stable").astype(np.int32)


def inverse_permutation(perm):
    """Inverse of a permutation (numpy array or torch tensor, same type
    out)."""
    if isinstance(perm, np.ndarray):
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
        return inv
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def group_offsets(page_ids_sorted, num_pages: int):
    """Start offset of each page group in a MARS-sorted stream of dense
    page ids (a torch tensor): int32 (num_pages + 1,), group ``g`` spans
    ``[offsets[g], offsets[g + 1])``.  Counted with ``scatter_add_`` on
    the tensor's device — ``torch.bincount`` on a CUDA tensor reads the
    ids' extremes back to the host, a sync per call."""
    counts = torch.zeros(num_pages, dtype=torch.int32,
                         device=page_ids_sorted.device)
    counts.scatter_add_(0, page_ids_sorted.long(),
                        torch.ones_like(page_ids_sorted, dtype=torch.int32))
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0, dtype=torch.int32)])


def mars_sort_by_page(page_ids, num_pages: int):
    """One-stop helper for kernels on a torch tensor of page ids:
    ``(perm, inv_perm, sorted_pages, offsets)``, all on the ids' device
    with no host round trip.  ``perm`` is a stable argsort (int32).

    For throughput consumers (MoE dispatch) page order is irrelevant, so
    this sorts by page id directly; latency consumers (the serving
    scheduler) use ``mars_order``'s first-arrival order."""
    perm = torch.argsort(page_ids, stable=True).to(torch.int32)
    sorted_pages = page_ids[perm.long()]
    return (perm, inverse_permutation(perm), sorted_pages,
            group_offsets(sorted_pages, num_pages))
