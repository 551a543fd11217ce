"""MARS-sorted embedding gather (port of ``repro/kernels/mars_gather/ops.py``).

Gathering rows in token order scatters reads over a (vocab x d) table;
MARS-sorting the ids groups the reads by table page, then the inverse
permutation restores order — identical values (see ``ref.py``).  The
sorted rows are copied by ``mars_gather.gather_rows``: the hand-written
Hopper kernel on a CUDA table, its plain twin on a CPU one.
"""
from __future__ import annotations

import torch

from repro_torch.core.reorder import inverse_permutation
from repro_torch.kernels.mars_gather.mars_gather import gather_rows
from repro_torch.kernels.mars_gather.ref import embedding_gather_ref

# rows per 4KB-ish HBM "page" bucket used as the MARS grouping key
_PAGE_SHIFT = 2


def embedding_gather(table: torch.Tensor, ids: torch.Tensor,
                     mode: str = "auto") -> torch.Tensor:
    shape = ids.shape
    flat = ids.reshape(-1)
    if mode == "plain" or (mode == "auto" and
                           table.shape[0] * table.shape[1] < (1 << 22)):
        out = embedding_gather_ref(table, flat)
        return out.reshape(*shape, table.shape[1])
    # MARS path: stable sort by page-of-row, gather grouped, unsort
    page = flat >> _PAGE_SHIFT
    perm = torch.argsort(page, stable=True)
    gathered = gather_rows(table, flat[perm])
    out = gathered[inverse_permutation(perm)]
    return out.reshape(*shape, table.shape[1])
