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

``save`` writes the single-shard form: a tree of ``DTensor`` leaves (a
sharded run over a mesh of processes) is gathered one leaf at a time,
and a leaf whose leading dimension is not cut one index of it (a stacked
leaf's layer) at a time; rank 0 alone writes each piece and drops it
before the next gather.  So a sharded run writes exactly the files a
one-process run writes, and no rank holds more of the gathered state
than one piece.  ``restore`` reassembles a multi-shard,
multi-manifest checkpoint as the reference's does, in numpy, and gives a
leaf that ``tree_like`` holds as a ``DTensor`` back as this rank's part
of it, placed alike.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import dtensor
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


def _layout(leaf) -> tuple[list, str]:
    """A leaf's whole shape and manifest dtype (a ``DTensor``'s global
    ones), without gathering it."""
    if not torch.is_tensor(leaf):
        arr, dtype = _to_numpy(leaf)
        return list(arr.shape), dtype
    if leaf.dtype == torch.bfloat16:
        return list(leaf.shape), _BF16
    return list(leaf.shape), str(torch.empty(0, dtype=leaf.dtype).numpy()
                                 .dtype)


def _pieces(leaf):
    """The whole leaf in C-order pieces (every rank of a ``DTensor``'s
    mesh walks them together: each piece is an all-gather): a ``DTensor``
    of two or more dimensions whose first is not cut, one index of that
    dimension at a time; another ``DTensor`` whole; a plain leaf as it
    is."""
    if not dtensor.is_dtensor(leaf):
        yield leaf
        return
    from torch.distributed.tensor import DTensor, Shard
    leaf = leaf.detach()
    if leaf.dim() < 2 or Shard(0) in leaf.placements:
        yield leaf.full_tensor()
        return
    part = leaf.to_local()
    to = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in leaf.placements]
    shape = leaf.shape[1:]
    stride = torch.empty(shape, device="meta").stride()
    for i in range(leaf.shape[0]):
        yield DTensor.from_local(part[i], leaf.device_mesh, to,
                                 run_check=False, shape=shape,
                                 stride=stride).full_tensor()


def _write(path: Path, shape, dtype: str, pieces) -> str:
    """``np.save`` of a leaf of ``shape`` from its C-order ``pieces``,
    each copied to the host, written and dropped in turn (a bfloat16
    leaf's header is the one numpy writes for an ``ml_dtypes`` bfloat16
    array, descr ``'<V2'``); returns ``_sha`` of its bytes."""
    descr = "<V2" if dtype == _BF16 else \
        np.lib.format.dtype_to_descr(np.dtype(dtype))
    sha = hashlib.sha1()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False,
                "shape": tuple(shape)})
        for piece in pieces:
            data = _to_numpy(piece)[0].tobytes()
            del piece
            sha.update(data)
            f.write(data)
            del data
    return sha.hexdigest()[:16]


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def save(tree, step: int, directory: str | os.PathLike,
         process_index: int | None = None) -> Path:
    """Write every leaf and the manifest; atomic rename on completion.
    ``DTensor`` leaves are gathered piece by piece (``_pieces``; every
    rank takes part) and only rank 0 writes; the other ranks wait for its
    rename."""
    spread = any(dtensor.is_dtensor(t) for _, t in leaf_paths(tree))
    if process_index is None:
        process_index = _rank()
    final = _save(tree, step, Path(directory), process_index,
                  manifest=process_index == 0 or not spread)
    if spread:
        dist.barrier()
    return final


def _save(tree, step: int, directory: Path, process_index: int = 0,
          manifest: bool = True) -> Path:
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    if manifest:
        (tmp / "shards").mkdir(parents=True, exist_ok=True)

    leaves = {}
    for name, leaf in leaf_paths(tree):
        shape, dtype = _layout(leaf)
        entry = {"shape": shape, "dtype": dtype, "shards": []}
        if process_index == 0:
            fname = f"{hashlib.sha1(name.encode()).hexdigest()[:16]}.npy"
            sha = _write(tmp / "shards" / fname, shape, dtype, _pieces(leaf))
            entry["shards"].append(
                {"index": [[0, d] for d in shape], "file": fname,
                 "sha1": sha})
        elif not manifest:
            for piece in _pieces(leaf):  # rank 0's gathers
                del piece
        leaves[name] = entry
    if not manifest:
        return final

    with open(tmp / f"manifest_{process_index}.json", "w") as f:
        json.dump({"step": step, "leaves": leaves}, f)
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

    def load(name, like):
        t = _assemble(directory, name, merged[name])
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        if dtensor.is_dtensor(like):
            mesh = dtensor.mesh_of(like)
            spec = dtensor.spec_of(like, mesh)
            t = dtensor.local_part(t, spec, mesh)
            return dtensor.distribute(t.to(like.device), spec, mesh)
        return t.to(device) if device is not None else t
    return _rebuild(tree_like, "", load)


def _rebuild(node, prefix: str, load):
    """``node``'s structure with every leaf replaced by ``load(its
    name, the leaf)`` (plain dicts for the mappings, named tuples
    kept)."""
    kids = children(node)
    if kids is None:
        return load(prefix, node)
    done = {n: _rebuild(c, f"{prefix}/{n}" if prefix else n, load)
            for n, c in kids}
    if hasattr(node, "_fields"):
        return type(node)(*(done["." + f] for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(done[str(i)] for i in range(len(node)))
    return {k: done[str(k)] for k in node.keys()}
