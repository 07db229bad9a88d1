"""Nested dict/list parameter trees, visited in the order JAX visits them:
dict keys sorted, lists in order; anything else, a tuple too, is a leaf.
That order fixes every flat vector a codec works on, so it has to be the
same on both sides."""
from __future__ import annotations


def items(tree, path=""):
    """[(path, leaf)] in flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += items(tree[k], f"{path}/{k}")
        return out
    if isinstance(tree, list):
        out = []
        for i, c in enumerate(tree):
            out += items(c, f"{path}/{i}")
        return out
    return [(path or "/", tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, c) for c in tree]
    return fn(tree)


def replace_leaves(tree, new):
    """``tree`` with its leaves, in flatten order, replaced by ``new``."""
    it = iter(new)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [walk(c) for c in node]
        return next(it)
    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
