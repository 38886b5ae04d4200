"""Nested dicts of tensors (the port's pytrees), walked in the reference's
leaf order: ``jax.tree_util`` visits a dict's keys sorted."""
from __future__ import annotations

from typing import Callable, Dict, List


def items(tree, prefix: str = "") -> List[tuple]:
    """(path, leaf) pairs in sorted-key order, the path's keys joined by
    ``/`` as ``repro.train.checkpoint`` joins them."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def unflatten(like, new_leaves) -> Dict:
    """A tree shaped like ``like`` holding ``new_leaves`` in its leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(like)


def map_leaves(tree, fn: Callable):
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)
