"""Weights from numpy into the port's parameter tree.

``params_from_numpy`` takes a parameter tree whose leaves are numpy
arrays — e.g. the reference's ``lm.init(cfg, key).params`` after
``jax.tree.map(np.asarray, ...)`` — with the reference's keys and
layouts, and returns the port's tree (``layers.as_module``) on
``device``.  bfloat16 leaves (numpy dtype name "bfloat16", from
``ml_dtypes``) cross as raw 16-bit patterns, so no ``ml_dtypes`` import
is needed here.  Every leaf keeps its own dtype: a hybrid model's SSM
``a_log``, ``dt_bias`` and ``d_skip`` stay float32 in a bfloat16 tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import as_module


def tensor_from_numpy(a) -> torch.Tensor:
    """numpy array -> CPU tensor of the same dtype and bits; bfloat16
    arrays cross as ``.view(uint16)`` -> ``.view(torch.bfloat16)``."""
    a = np.array(a, order="C")        # a writable copy the tensor owns
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda"):
    """Convert a numpy parameter tree to the port's tree on ``device``.
    Every leaf under a block stack must carry its stacked layer axis:
    ``blocks_dense`` (an MoE model's leading dense blocks) leads with
    ``n_dense_layers``, ``blocks`` with the remaining layers, an
    encoder-decoder model's ``encoder`` with ``enc_layers``."""
    depth = {name: n for name, _, n in lm._stacks(cfg)}
    if cfg.enc_layers:
        depth["encoder"] = cfg.enc_layers

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        t = tensor_from_numpy(node)
        if (path[0].startswith("blocks") or path[0] == "encoder") and \
                t.shape[0] != depth.get(path[0], -1):
            raise ValueError(f"{'/'.join(path)}: leading axis {t.shape[0]} "
                             f"!= {depth.get(path[0], 0)} stacked layers of "
                             f"{path[0]}")
        return t.to(device)
    return as_module(conv(tree, ()))
