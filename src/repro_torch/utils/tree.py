"""Nested parameter and cache trees: dicts, tuples and lists of tensors.

The LM keeps the reference's pytree layout (``models/lm/model.py``); these
are the ``jax.tree`` functions it needs.  Leaves are visited in the trees'
own order (dict insertion order, then sequence order); ``None`` is no
leaf.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path", "tree_unflatten"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    """``(path, leaf)`` pairs; a path holds dict keys and sequence indices."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in tree_leaves_with_path(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree) for pl in tree_leaves_with_path(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves(like)`` order) in ``like``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
