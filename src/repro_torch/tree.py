"""Parameter trees: the port's counterpart of JAX pytrees.

Parameters are nested dicts, lists and tuples of tensors, mirroring the
reference's pytrees node for node; a NamedTuple (a decode state's
`KVCache`, `SSMState`, `LRUState`) is a node whose fields are its
children. Flattening walks a dict's keys in sorted order and a list's or
tuple's items in index order, as JAX orders their children, so a tree's
leaves come out in one fixed order whatever order its dicts were built
in. Anything else is a leaf, and so is any node for which a given
`is_leaf` holds.

`tree_map_with_path` hands `fn` each leaf's key path, the reference's
`jax.tree_util.tree_map_with_path`: a tuple of `DictKey` (a dict's key),
`SequenceKey` (a list's or plain tuple's index) and `GetAttrKey` (a
NamedTuple's field), the roles of JAX's key types of those names, which
the sharding rules (`repro_torch.sharding`) read."""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

_SEQUENCES = (list, tuple)


class DictKey(NamedTuple):
    key: object


class SequenceKey(NamedTuple):
    idx: int


class GetAttrKey(NamedTuple):
    name: str


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _rebuild(node, children):
    """A node of `node`'s type holding `children` (a NamedTuple takes
    them as its fields)."""
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, _SEQUENCES):
        return _rebuild(tree, [tree_map(fn, v, *(r[i] for r in rest))
                               for i, v in enumerate(tree)])
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest,
                       is_leaf: Optional[Callable] = None, _path=()):
    """`fn(path, leaf, *rest_leaves)` leafwise, `path` the leaf's key path
    from the root (see the module's docstring)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(_path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      is_leaf=is_leaf,
                                      _path=_path + (DictKey(k),))
                for k, v in tree.items()}
    if isinstance(tree, _SEQUENCES):
        fields = getattr(tree, "_fields", None)
        return _rebuild(tree, [tree_map_with_path(
            fn, v, *(r[i] for r in rest), is_leaf=is_leaf,
            _path=_path + (GetAttrKey(fields[i]) if fields
                           else SequenceKey(i),))
            for i, v in enumerate(tree)])
    return fn(_path, tree, *rest)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> List:
    """The leaves of `tree`: keys sorted at every dict, items in order at
    every list or tuple."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, _SEQUENCES):
        return [leaf for v in tree for leaf in tree_leaves(v, is_leaf)]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, _SEQUENCES):
        return _rebuild(tree, [_structure(v) for v in tree])
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
            return _rebuild(node, [fill(v) for v in node])
        return next(it)

    out = fill(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
