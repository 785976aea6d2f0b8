"""Minimal deterministic batching pipeline for client-local training (the
port's own numpy copy of `repro.data.pipeline`: identical index batches)."""
from __future__ import annotations

import numpy as np


class ClientDataset:
    """A satellite's local shard: deterministic minibatch stream."""

    def __init__(self, indices: np.ndarray, client_id: int, seed: int = 0):
        self.indices = np.asarray(indices)
        self.client_id = int(client_id)
        self.seed = seed

    def __len__(self):
        return len(self.indices)

    def batches(self, round_rng: int, batch_size: int, num_batches: int):
        """num_batches index batches for one local round (eq. 3 minibatches).
        Deterministic given (client, round_rng)."""
        if len(self.indices) == 0:
            return np.zeros((num_batches, 0), np.int64)
        rng = np.random.default_rng(
            (self.seed * 7_919 + self.client_id * 104_729 + round_rng)
            % 2 ** 63)
        picks = rng.integers(0, len(self.indices),
                             (num_batches, min(batch_size,
                                               len(self.indices))))
        return self.indices[picks]


def make_clients(parts, seed: int = 0):
    return [ClientDataset(p, k, seed) for k, p in enumerate(parts)]
