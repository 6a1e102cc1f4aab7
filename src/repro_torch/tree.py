"""Nested containers of tensors in the reference's pytree order.

JAX flattens a dict by its sorted keys and a tuple, list or NamedTuple
in order, and an empty tuple or None holds no leaf.  The gradient
compressor seeds its hashes by a leaf's index, and a checkpoint names
its files by it, so the port flattens the same way.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [x for c in kids for x in leaves(c)]


def paths(tree, prefix: str = "") -> List[str]:
    """Dotted names of the leaves, in :func:`leaves`' order (``layers.attn.wq``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, c in enumerate(tree) for p in paths(c, f"{prefix}{i}.")]
    return [prefix[:-1]]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(c) for c in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leafwise over trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest))])
