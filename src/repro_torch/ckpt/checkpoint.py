"""Parameter trees on npz, and the version-indexed global-model store the
FL server keeps the bases in that buffered and pending satellites still
train from (w^{i-s} for s <= s_max).

The port of `repro.ckpt.checkpoint`: `save_pytree`/`load_pytree` write
and read the reference's npz layout — one array per leaf under its
path-joined key ("a/b", list items by index) — so a file written by
either package loads into the other's tree. The `CheckpointStore` is
memory-only: stored models are parameter dicts left on the run's device,
so fetching a base costs no transfer. The reference's disk spill and its
device ring (`DeviceCheckpointStore`, a JAX buffer-donation idiom) are
not ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten


def _paths(tree, prefix=""):
    """(key, leaf) pairs in the tree's leaf order, keys joined by "/" as
    the reference joins its pytree paths."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def save_pytree(path: str, tree) -> None:
    """Save a tree of tensors to `path` as an npz of path-keyed leaves
    (parent directories are created; `load_pytree` restores it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in _paths(tree)})


def load_pytree(path: str, like) -> Any:
    """Restore into the structure of `like`, a tree of tensors (shapes
    must match): each leaf takes the dtype and device of `like`'s."""
    data = np.load(path)
    _, structure = tree_flatten(like)
    return tree_unflatten(structure, [
        torch.as_tensor(np.asarray(data[key])).to(
            device=leaf.device, dtype=leaf.dtype).reshape(leaf.shape)
        for key, leaf in _paths(like)])


class CheckpointStore:
    """Keeps every version still referenced, and never fewer than the
    newest `keep_in_memory` versions."""

    def __init__(self, keep_in_memory: int = 32):
        self.keep = keep_in_memory
        self._mem: Dict[int, Any] = {}

    def put(self, version: int, params) -> None:
        """Store `params` (a dict of tensors) under integer `version`."""
        self._mem[version] = params

    def prune(self, min_referenced: int) -> None:
        """Drop versions older than the oldest still-referenced base
        (callers pass min over satellites' pending/buffered bases), but
        never shrink below `keep` recent versions."""
        if not self._mem:
            return
        newest = max(self._mem)
        cutoff = min(min_referenced, newest - self.keep + 1)
        for v in [v for v in self._mem if v < cutoff]:
            del self._mem[v]

    def get(self, version: int):
        """Fetch the stored params for `version`. Raises KeyError for
        evicted/unknown versions."""
        if version in self._mem:
            return self._mem[version]
        raise KeyError(f"version {version} evicted "
                       f"(have {sorted(self._mem)[:4]}..)")

    def versions(self) -> List[int]:
        """Sorted list of every retrievable version."""
        return sorted(self._mem)
