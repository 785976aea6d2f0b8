"""Nested-dict parameter trees: the port's counterpart of JAX pytrees.

Parameters are plain dicts of tensors (nesting allowed), mirroring the
reference's pytrees key for key."""
from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply `fn` leafwise over dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
