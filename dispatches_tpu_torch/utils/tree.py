"""Nested-container helpers: the part of ``jax.tree_util`` the port's
plan and serve layers use.

A tree is a leaf or a dict, list, tuple or NamedTuple of trees; ``None``
is an empty subtree (no leaves), as in ``jax.tree_util``.  Dicts flatten
in sorted-key order, which is the order ``jax.tree_util`` uses, so a
parameter vector built from the leaves lines up with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_leaves", "tree_map", "tree_structure", "treedef_repr"]


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


def treedef_repr(tree) -> str:
    """The text ``repr(jax.tree_util.tree_structure(tree))`` gives for a
    tree of dicts, lists, tuples, NamedTuples, ``None`` and leaves, e.g.
    ``PyTreeDef({'fixed': {}, 'p': {'a': *}})``, and a NamedTuple as
    ``CustomNode(namedtuple[Name], [*, *])``: hashes keyed by it equal the
    JAX package's, and a NamedTuple hashes apart from a tuple."""

    def body(t) -> str:
        if t is None:
            return "None"
        if _is_namedtuple(t):
            inner = ", ".join(body(v) for v in t)
            return f"CustomNode(namedtuple[{type(t).__name__}], [{inner}])"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {body(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(body(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(body(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({body(tree)})"


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
