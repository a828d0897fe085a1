"""Nested parameter and cache trees: dicts, tuples and lists of tensors.

The LM keeps the reference's pytree layout (``models/lm/model.py``); this
is the one ``jax.tree`` function it needs.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["tree_map"]


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

