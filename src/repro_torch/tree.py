"""Nested dicts and lists of tensors (the port's parameter, optimizer and
checkpoint trees), walked as ``jax.tree_util`` walks the reference's.

Order: a dict's keys sorted, a list's or tuple's items in order, as JAX
flattens them, so a sum over :func:`leaves` adds in the reference's
order.  A leaf's key is its path joined by ``/`` (dict keys as ``str``,
sequence indices as decimal), the reference checkpoint's
``_leaf_key``.  ``None`` is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_path(tree, is_leaf: Optional[Callable] = None
                      ) -> list[tuple[str, Any]]:
    """[(key, leaf)] in the reference's order."""
    out: list[tuple[str, Any]] = []

    def walk(t, path):
        if t is None:
            return
        if (is_leaf is not None and is_leaf(t)) or not _is_node(t):
            out.append(("/".join(path), t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        else:
            for i, v in enumerate(t):
                walk(v, path + (str(i),))

    walk(tree, ())
    return out


def leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def map_tree(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the aligned leaves of
    ``rest``; the result has ``tree``'s structure (tuples stay tuples)."""
    if tree is None:
        return None
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    out = [map_tree(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, v in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def map_with_path(fn: Callable, tree, is_leaf: Optional[Callable] = None):
    """``fn(key, leaf)`` over the leaves of ``tree`` (``key`` as in
    :func:`flatten_with_path`); the result has ``tree``'s structure."""
    def walk(t, path):
        if t is None:
            return None
        if (is_leaf is not None and is_leaf(t)) or not _is_node(t):
            return fn("/".join(path), t)
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        out = [walk(v, path + (str(i),)) for i, v in enumerate(t)]
        return tuple(out) if isinstance(t, tuple) else out

    return walk(tree, ())


def unflatten(tree, values):
    """``tree``'s structure (dicts with their keys sorted) with its leaves
    replaced, in :func:`leaves`' order, by ``values``."""
    it = iter(values)

    def walk(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        out = [walk(v) for v in t]
        return tuple(out) if isinstance(t, tuple) else out

    return walk(tree)


__all__ = ["flatten_with_path", "leaves", "map_tree", "map_with_path",
           "unflatten"]
