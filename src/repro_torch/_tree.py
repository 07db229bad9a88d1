"""Parameter-tree utilities: the port's stand-in for ``jax.tree.*``.

A tree is nested dicts, lists and tuples; anything else is a leaf (a
``torch.Tensor`` or a host ``numpy`` array). Dict keys are visited in
sorted order, as ``jax.tree.flatten`` visits them, so the leaf order —
and with it every flat vector and wire buffer list built from a tree —
matches the JAX reference (``src/repro/core/serialization.py:83,129``,
``src/repro/kernels/ops.py:220``). Insertion order would not: the ResNet
tree is built ``stem, stage0..2, head`` but flattens ``head`` first.

A treedef is a plain nested tuple, so it pickles onto a wire:
``None`` for a leaf, ``("dict", keys, children)``, ``("list", children)``
or ``("tuple", children)``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree) -> Tuple[List[Any], tuple]:
    """-> (leaves in JAX order, treedef)."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _flatten(node, leaves):
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_flatten(node[k], leaves) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return None


def unflatten(treedef, leaves):
    """Inverse of ``flatten``: rebuild the tree with ``leaves`` in order."""
    it = iter(leaves)
    tree = _unflatten(treedef, it)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more leaves than the treedef holds")
    return tree


_END = object()


def _unflatten(treedef, it):
    if treedef is None:
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("unflatten: fewer leaves than the treedef holds")
        return leaf
    if treedef[0] == "dict":
        _, keys, children = treedef
        return {k: _unflatten(c, it) for k, c in zip(keys, children)}
    children = [_unflatten(c, it) for c in treedef[1]]
    return children if treedef[0] == "list" else tuple(children)


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must share its treedef)."""
    ls, treedef = flatten(tree)
    others = []
    for r in rest:
        rl, rdef = flatten(r)
        if rdef != treedef:
            raise ValueError("map: trees have different structures")
        others.append(rl)
    return unflatten(treedef, [fn(*args) for args in zip(ls, *others)])
