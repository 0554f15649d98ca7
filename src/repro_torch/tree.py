"""Nested dict / tuple / list trees of tensors: the port's stand-in for
``jax.tree`` (leaves in depth-first order, dict entries in sorted key
order as JAX flattens them)."""

from __future__ import annotations

import dataclasses


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return None


def tree_leaves(tree) -> list:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in tree_leaves(k)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(k) for k in t)
        return type(t)(*[build(k) for k in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the same-shaped
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*[
            tree_map(fn, getattr(tree, f.name),
                     *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)])
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping the
    structure; ``path`` is the tuple of dict keys, sequence indices and
    dataclass field names from the root to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*[
            tree_map_with_path(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)])
    return fn(path, tree)
