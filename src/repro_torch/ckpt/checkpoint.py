"""Parameter trees on npz, and the version-indexed global-model store the
FL server keeps the bases in that buffered and pending satellites still
train from (w^{i-s} for s <= s_max).

The port of `repro.ckpt.checkpoint`: `save_pytree`/`load_pytree` write
and read the reference's npz layout — one array per leaf under its
path-joined key ("a/b", list items by index) — so a file written by
either package loads into the other's tree. The `CheckpointStore` keeps
its models as parameter trees left on the run's device, so fetching a
base costs no transfer, and optionally spills every `spill_every`-th
version to `w_{version:06d}.npz` in `directory` (the reference's names
and keys); a spilled version loads back onto the device of the stored
trees. The engine keeps its memory-only use, as the reference's does.

The reference's `DeviceCheckpointStore` is not ported: it is a stacked
ring buffer that JAX updates in place through buffer donation, so that
its engine reads base checkpoints without a host-to-device transfer. The
port's store already keeps its tensors on the run's device, so it has
nothing left to do.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

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
    """Version-indexed global-model store. Keeps every version still
    referenced, never fewer than the newest `keep_in_memory` versions, and
    (optionally) spills every `spill_every`-th version to `directory` —
    the utility estimator needs w^{i-s} for s <= s_max, the FL server
    needs old bases for stale satellites."""

    def __init__(self, directory: Optional[str] = None,
                 keep_in_memory: int = 32, spill_every: int = 0):
        self.dir = directory
        self.keep = keep_in_memory
        self.spill_every = spill_every
        self._mem: Dict[int, Any] = {}
        self._disk: Dict[int, str] = {}
        self._like = None

    def put(self, version: int, params) -> None:
        """Store `params` (a tree of tensors) under integer `version`;
        spills to disk as well when the version hits the `spill_every`
        stride."""
        self._like = params
        self._mem[version] = params
        if self.dir and self.spill_every and version % self.spill_every == 0:
            p = os.path.join(self.dir, f"w_{version:06d}.npz")
            save_pytree(p, params)
            self._disk[version] = p

    def prune(self, min_referenced: int) -> None:
        """Drop versions older than the oldest still-referenced base
        (callers pass min over satellites' pending/buffered bases), but
        never shrink below `keep` recent versions. The cutoff applies to
        the disk spill too: spilled files are unlinked, so long runs with
        `spill_every` set stay disk-bounded."""
        if not self._mem:
            return
        newest = max(self._mem)
        cutoff = min(min_referenced, newest - self.keep + 1)
        for v in [v for v in self._mem if v < cutoff]:
            del self._mem[v]
        for v in [v for v in self._disk if v < cutoff]:
            try:
                os.unlink(self._disk[v])
            except OSError:
                pass
            del self._disk[v]

    def get(self, version: int):
        """Fetch the stored params for `version` (memory first, then the
        disk spill, loaded onto the device of the stored trees). Raises
        KeyError for evicted/unknown versions."""
        if version in self._mem:
            return self._mem[version]
        if version in self._disk:
            return load_pytree(self._disk[version], self._like)
        raise KeyError(f"version {version} evicted "
                       f"(have {sorted(self._mem)[:4]}..)")

    def versions(self) -> List[int]:
        """Sorted list of every retrievable version (memory + disk)."""
        return sorted(set(self._mem) | set(self._disk))
