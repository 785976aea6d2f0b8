"""Parameter trees: the port's counterpart of JAX pytrees.

Parameters are nested dicts, lists and tuples of tensors, mirroring the
reference's pytrees node for node. Flattening walks a dict's keys in
sorted order and a list's or tuple's items in index order, as JAX orders
their children, so a tree's leaves come out in one fixed order whatever
order its dicts were built in. Anything else is a leaf."""
from __future__ import annotations

from typing import Callable, List, Tuple

_SEQUENCES = (list, tuple)


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, _SEQUENCES):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of `tree`: keys sorted at every dict, items in order at
    every list or tuple."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, _SEQUENCES):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, _SEQUENCES):
        return type(tree)(_structure(v) for v in tree)
    return None


def tree_flatten(tree) -> Tuple[List, object]:
    """(leaves, structure): `tree_unflatten(structure, leaves)` rebuilds
    the tree."""
    return tree_leaves(tree), _structure(tree)


def tree_unflatten(structure, leaves):
    """Inverse of `tree_flatten`: fill `structure` with `leaves` in
    order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, _SEQUENCES):
            return type(node)(fill(v) for v in node)
        return next(it)

    out = fill(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
