"""Nested tuples, lists and dicts of leaves: the port's small stand-in for
``jax.tree`` (batches, optimizer state)."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of nested tuples, lists and dicts, in order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree: Any) -> list:
    """The leaves in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out
