"""Collective-traffic accounting (the port's counterpart of
``repro/utils/hlo.py``).

The reference parses the optimized HLO text of a compiled step and sums
the output bytes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute, weighting an instruction inside a
``while`` body by its trip count.  The port has no HLO: it records the
collectives its step actually issues.  ``record()`` is a
``TorchDispatchMode`` that sees every ``torch.distributed`` collective
called inside it, the c10d ops (``dist.all_reduce`` and the like) and
the functional ones ``DTensor.redistribute`` issues, with real tensors
or fake ones over the fake process group.  A collective inside the
layer loop is recorded once per call: the port's form of the trip-count
weighting.  ``collective_bytes`` sums the records in the reference's
layout.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (c10d and _c10d_functional alike) -> kind; an op not named here
# (wait_tensor, barrier, broadcast, ...) moves no traffic the reference
# counts and is not recorded
_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call: its kind, its op and the bytes of its
    outputs."""
    kind: str
    op: str
    bytes: int


def flat_tensors(tree) -> list:
    """The tensors of a nest of lists and tuples, in order.  A loop, not
    a recursive closure: a closure that calls itself is a reference
    cycle, which would keep the list and its tensors alive until Python's
    cycle collector runs (``StepMeter`` would count them as live)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
    return out


def output_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class record(TorchDispatchMode):
    """``with record() as rec:`` appends a ``Collective`` to ``rec.calls``
    for every collective issued inside.  A c10d op writes its first
    argument in place (``allreduce_``'s tensors, ``_allgather_base_``'s
    output, ...): those are its outputs; a functional op's outputs are
    what it returns.  A ``DTensor`` op is let through to ``DTensor``,
    whose redistributions then reach the mode as functional ops."""

    def __init__(self):
        super().__init__()
        self.calls: list[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = getattr(func, "namespace", None)
        name = getattr(func, "_overloadpacket", func).__name__
        kind = _KINDS.get(name) if ns in _NAMESPACES else None
        if kind is not None:
            outs = flat_tensors(args[0]) if ns == "c10d" \
                else flat_tensors(out)
            self.calls.append(Collective(kind, f"{ns}.{name}",
                                         output_bytes(outs)))
        return out


def collective_bytes(records) -> dict:
    """The reference's layout (``hlo.collective_bytes``): the output bytes
    of each kind that occurs, ``"{kind}_count"`` its calls, and
    ``"total"`` over the five kinds."""
    out: dict = defaultdict(int)
    for r in records:
        out[r.kind] += r.bytes
        out[f"{r.kind}_count"] += 1
    out["total"] = sum(out[c] for c in COLLECTIVES if c in out)
    return dict(out)
