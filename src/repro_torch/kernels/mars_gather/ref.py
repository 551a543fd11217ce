"""Plain oracle for the MARS-sorted embedding gather.

The contract: ``gather(table, ids) == table[ids]`` exactly — the MARS
reorder is a pure performance transform and must be bit-transparent.
"""
from __future__ import annotations

import torch


def embedding_gather_ref(table: torch.Tensor, ids: torch.Tensor):
    """table: (V, D); ids: int (...) -> (..., D)."""
    return table[ids]
