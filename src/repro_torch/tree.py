"""Nested containers of arrays (the port's stand-in for JAX pytrees), in the
order and with the key paths ``jax.tree_util`` gives them: dict keys
sorted, lists and tuples by index, ``None`` an empty subtree.  The optimizer
state, the train state and the checkpoint files follow this order, so they
line up leaf for leaf with the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def _children(node) -> list[tuple[Any, Any]] | None:
    """(key, child) pairs of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def tree_flatten_with_path(tree: PyTree, upto: PyTree = None) -> list[tuple[tuple, Any]]:
    """(key path, leaf) of every leaf of ``tree``.  With ``upto`` (a tree
    whose structure is a prefix of ``tree``'s), the leaves are the subtrees
    of ``tree`` at ``upto``'s leaves (``flatten_up_to``)."""
    out: list[tuple[tuple, Any]] = []

    def walk(node, shape, path):
        kids = _children(shape)
        if kids is None:
            out.append((path, node))
            return
        for key, sub in kids:
            if sub is not None:
                walk(node[key], sub, path + (key,))

    walk(tree, tree if upto is None else upto, ())
    return out


def tree_leaves(tree: PyTree, upto: PyTree = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, upto)]


def tree_unflatten(template: PyTree, leaves) -> PyTree:
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in kids}
        return type(node)(build(v) for _, v in kids)

    out = build(template)
    if next(it, it) is not it:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` of each leaf of ``tree`` and the subtrees of ``rest`` at the
    same place."""
    cols = [tree_leaves(tree)] + [tree_leaves(r, upto=tree) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
