"""Version-indexed global-model store: the FL server keeps the bases that
buffered and pending satellites still train from (w^{i-s} for s <= s_max).

The port of `repro.ckpt.checkpoint.CheckpointStore`, memory-only: stored
models are parameter dicts left on the run's device, so fetching a base
costs no transfer. The reference's disk spill, npz save/load and its
device ring (`DeviceCheckpointStore`, a JAX buffer-donation idiom) are not
ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List


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
