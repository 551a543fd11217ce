"""Atomic checkpoints in the reference's on-disk format (port of
``repro/ft/checkpoint.py``).

The format, file for file the reference's:
  * one ``.npy`` per leaf under ``step_NNNNNNNN/shards/``, named by the
    sha1 of the leaf's path (``p/blocks/attn/wq``, ``o/.m/...``,
    ``o/.step``; ``utils.tree.leaf_paths`` names leaves as the
    reference's ``_leaf_paths``), and ``manifest_0.json`` with each
    leaf's shape, dtype and shards (index ranges, file, sha1 of the
    bytes);
  * written under ``step_NNNNNNNN.tmp/`` and renamed in one step, the
    manifest last, so a crashed writer never leaves a half-valid
    checkpoint; the newest 3 are kept.

So a checkpoint written by either package restores in the other.
bfloat16 leaves cross as their 16-bit patterns: ``np.save`` of the
reference's ``ml_dtypes`` arrays writes numpy descr ``'<V2'`` with
manifest dtype ``"bfloat16"``, and this module writes and reads those
leaves as ``uint16`` bytes viewed as ``torch.bfloat16`` (the card's
machine has no ``ml_dtypes``), as ``convert.tensor_from_numpy`` does.

One card holds every leaf whole, so ``save`` writes the single-shard
form (the reference's sharded save of ``addressable_shards`` has no
counterpart); ``restore`` reassembles a multi-shard, multi-manifest
checkpoint as the reference's does, in numpy.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.utils.tree import children, leaf_paths

_BF16 = "bfloat16"


def _sha(data: np.ndarray) -> str:
    return hashlib.sha1(data.tobytes()).hexdigest()[:16]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array ``np.save`` writes and its manifest dtype.
    Python ints and floats become int32 and float32, as ``jnp.asarray``
    makes them."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        if arr.dtype.kind == "i":
            arr = arr.astype(np.int32)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write(path: Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save`` of the leaf; a bfloat16 leaf (``arr`` its uint16
    patterns) with the header numpy writes for an ``ml_dtypes`` bfloat16
    array, descr ``'<V2'``."""
    if dtype != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def save(tree, step: int, directory: str | os.PathLike,
         process_index: int = 0) -> Path:
    """Write every leaf and the manifest; atomic rename on completion."""
    directory = Path(directory)
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    (tmp / "shards").mkdir(parents=True, exist_ok=True)

    manifest = {"step": step, "leaves": {}}
    for name, leaf in leaf_paths(tree):
        arr, dtype = _to_numpy(leaf)
        entry = {"shape": list(arr.shape), "dtype": dtype, "shards": []}
        if process_index == 0:
            fname = f"{hashlib.sha1(name.encode()).hexdigest()[:16]}.npy"
            _write(tmp / "shards" / fname, arr, dtype)
            entry["shards"].append(
                {"index": [[0, d] for d in arr.shape], "file": fname,
                 "sha1": _sha(arr)})
        manifest["leaves"][name] = entry

    with open(tmp / f"manifest_{process_index}.json", "w") as f:
        json.dump(manifest, f)
    if process_index == 0:
        os.replace(tmp, final)
        _gc(directory, keep=3)
    return final


def _gc(directory: Path, keep: int):
    steps = sorted(directory.glob("step_[0-9]*"))
    steps = [s for s in steps if not s.name.endswith(".tmp")]
    for s in steps[:-keep]:
        shutil.rmtree(s, ignore_errors=True)


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.name.split("_")[1])
                   for p in directory.glob("step_[0-9]*")
                   if not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _assemble(directory: Path, name: str, entry: dict) -> torch.Tensor:
    """One leaf from its shards (bfloat16 as its 16-bit patterns)."""
    bf16 = entry["dtype"] == _BF16
    full = np.zeros(entry["shape"], np.uint16 if bf16 else entry["dtype"])
    for sh in entry["shards"]:
        data = np.load(directory / "shards" / sh["file"])
        if _sha(data) != sh["sha1"]:
            raise IOError(f"checksum mismatch for {name}:{sh['file']}")
        idx = tuple(slice(a, b) for a, b in sh["index"])
        full[idx] = data.view(np.uint16) if bf16 else data
    t = torch.from_numpy(full)
    return t.view(torch.bfloat16) if bf16 else t


def restore(tree_like, step: int, directory: str | os.PathLike,
            device=None, dtype=None):
    """The tree at ``step``.  ``tree_like`` supplies the structure (its
    leaf names); each leaf comes back as a tensor of the saved dtype on
    ``device`` (default: the CPU), floating leaves cast to ``dtype``
    where one is given."""
    directory = Path(directory) / f"step_{step:08d}"
    merged: dict = {}
    for m in sorted(directory.glob("manifest_*.json")):
        with open(m) as f:
            data = json.load(f)
        for name, entry in data["leaves"].items():
            e = merged.setdefault(name, {"shape": entry["shape"],
                                         "dtype": entry["dtype"],
                                         "shards": []})
            e["shards"].extend(entry["shards"])

    def load(name):
        t = _assemble(directory, name, merged[name])
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device) if device is not None else t
    return _rebuild(tree_like, "", load)


def _rebuild(node, prefix: str, load):
    """``node``'s structure with every leaf replaced by ``load(its
    name)`` (plain dicts for the mappings, named tuples kept)."""
    kids = children(node)
    if kids is None:
        return load(prefix)
    done = {n: _rebuild(c, f"{prefix}/{n}" if prefix else n, load)
            for n, c in kids}
    if hasattr(node, "_fields"):
        return type(node)(*(done["." + f] for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(done[str(i)] for i in range(len(node)))
    return {k: done[str(k)] for k in node.keys()}
