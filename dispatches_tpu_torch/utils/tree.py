"""Nested-container helpers: the part of ``jax.tree_util`` the port's
plan and serve layers use.

A tree is a leaf or a dict, list, tuple or NamedTuple of trees; ``None``
is an empty subtree (no leaves), as in ``jax.tree_util``.  Dicts flatten
in sorted-key order, which is the order ``jax.tree_util`` uses, so a
parameter vector built from the leaves lines up with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_leaves", "tree_map", "tree_structure"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_structure(tree) -> Tuple:
    """A hashable description of ``tree``'s containers (no leaf values)."""
    if tree is None:
        return ("None",)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, tree_structure(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(tree_structure(v) for v in tree)
    return ("*",)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and the matching trees
    ``rest``; containers keep their type, ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
