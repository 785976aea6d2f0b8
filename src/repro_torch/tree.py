"""Nested-dict parameter trees: the port's counterpart of JAX pytrees.

Parameters are plain dicts of tensors (nesting allowed), mirroring the
reference's pytrees key for key. Flattening walks the keys in sorted
order at every level, as JAX orders a dict's children, so a tree's leaves
come out in one fixed order whatever order its dicts were built in."""
from __future__ import annotations

from typing import Callable, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of `tree`, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    return None


def tree_flatten(tree) -> Tuple[List, dict]:
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
        return next(it)

    out = fill(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
