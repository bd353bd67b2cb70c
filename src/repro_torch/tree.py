"""Nested dicts of tensors as the JAX package's pytrees: leaves in
``jax.tree`` order (dict keys sorted), and a map over trees of one
structure."""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of a nested dict (or tuple/list of them), keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which have its structure; the result has it too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, flat: list):
    """The values of ``flat``, in ``leaves(tree)`` order, in the structure
    of ``tree``."""
    it = iter(flat)

    def rec(node):
        if isinstance(node, dict):
            out = {k: rec(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(rec(v) for v in node)
        return next(it)
    return rec(tree)
