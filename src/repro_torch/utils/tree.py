"""Nested parameter and state trees, walked in JAX's order.

A tree is a nested ``dict`` — or the port's parameter tree of
``nn.ModuleDict`` / ``nn.ParameterDict`` (``models.layers.as_module``) —
or a ``NamedTuple`` of trees (an optimizer state), with tensors (or
numbers) at its leaves.  ``leaf_paths`` walks it as
``jax.tree_util.tree_flatten_with_path`` walks the reference's trees:
dict keys sorted, a named tuple's fields in order, and names each leaf
as ``repro/ft/checkpoint.py:_leaf_paths`` does (a dict key as itself, a
named tuple's field as ``.field``, parts joined by "/"), so the port and
the reference give the same leaf the same name and sum leaves in the
same order.
"""
from __future__ import annotations

from torch import nn

_MAPS = (dict, nn.ModuleDict, nn.ParameterDict)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def children(node):
    """(name, child) pairs of an inner node in JAX's order, or None for a
    leaf."""
    if isinstance(node, _MAPS):
        return [(str(k), node[k]) for k in sorted(node.keys())]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaf_paths(tree, prefix: str = "") -> list:
    """[(name, leaf)] of every leaf, in JAX's flatten order."""
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for name, child in kids:
        out += leaf_paths(child, f"{prefix}/{name}" if prefix else name)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaf_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each of
    ``rest``), returning plain nested dicts (a named tuple stays one)."""
    if isinstance(tree, _MAPS):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree.keys()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    return fn(tree, *rest)


def as_dict(tree):
    """The tree's leaves as nested plain dicts (the same tensors)."""
    return tree_map(lambda x: x, tree)
