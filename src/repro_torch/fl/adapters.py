"""Model adapters: bind a model family to the FL engine (init/loss/eval +
deterministic client batches). Parameters are dicts of tensors on the
adapter's device, mirroring the reference's pytrees key for key.

The port of `repro.fl.adapters` holds the quickstart's MLP adapter; the
DenseNet and transformer adapters come with later slices.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.data.fmow import NUM_CLASSES, SyntheticFmow
from repro_torch.data.pipeline import ClientDataset
from repro_torch.fl.registry import register_adapter


def _xent(logits, labels):
    """Mean cross-entropy over the batch axis. logits (..., B, C), labels
    (..., B) -> (...): a leading satellite axis gives one loss each."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - ll).mean(dim=-1)


@register_adapter("mlp")
class MlpFmowAdapter:
    """Fast path: 62-class classification over feature vectors.

    `apply` and `loss` take parameters with or without a leading satellite
    axis: the batched client update trains a stack of satellites as one
    batched product. The products are plain `torch.matmul`s (the reference
    leaves them to XLA), run in full float32: TF32 is switched off for CUDA
    matmuls when the adapter is built, so the card computes the same
    products as the reference's float32 dots."""

    name = "mlp"

    def __init__(self, data: SyntheticFmow, clients: List[ClientDataset],
                 hidden: int = 64, *, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.data = data
        self.clients = clients
        self.hidden = hidden
        self.device = torch.device(device)
        # features are built on the host exactly as the reference builds
        # them, then held on the device; batches are gathered there
        self._X_train_np = data.features(np.arange(data.spec.num_train),
                                         "train")
        self._X_train = torch.as_tensor(self._X_train_np, device=self.device)
        self._y_train = torch.as_tensor(data.train_labels,
                                        device=self.device)
        self._X_val = torch.as_tensor(
            data.features(np.arange(data.spec.num_val), "val"),
            device=self.device)
        self._y_val = torch.as_tensor(data.val_labels, device=self.device)

    def init(self, generator: torch.Generator):
        """Random initial model drawn from `generator` (a CPU generator, so
        the same seed gives the same model on every device; the numbers
        differ from the reference's `jax.random` draw — see
        `repro_torch.weights`)."""
        F, H = self._X_train.shape[1], self.hidden
        w1 = torch.randn(F, H, generator=generator) * F ** -0.5
        w2 = torch.randn(H, NUM_CLASSES, generator=generator) * H ** -0.5
        return {"w1": w1.to(self.device),
                "b1": torch.zeros(H, device=self.device),
                "w2": w2.to(self.device),
                "b2": torch.zeros(NUM_CLASSES, device=self.device)}

    def apply(self, params, X):
        h = torch.tanh(X @ params["w1"] + params["b1"].unsqueeze(-2))
        return h @ params["w2"] + params["b2"].unsqueeze(-2)

    def loss(self, params, batch):
        X, y = batch
        return _xent(self.apply(params, X), y)

    def client_batch(self, client_idx: int, round_rng: int, batch_size: int,
                     num_batches: int):
        idx = self.clients[client_idx].batches(round_rng, batch_size,
                                               num_batches)
        if idx.shape[1] == 0:
            return None
        idx = torch.as_tensor(idx, device=self.device)
        return self._X_train[idx], self._y_train[idx]

    def _client_batch_indices(self, client_ids, round_rng: int,
                              batch_size: int, num_batches: int):
        """Index batches for a client set, restricted to the modal batch
        width so they stack. Returns (idx (M, num_batches, b), rows), rows
        being the positions of `client_ids` included; clients with empty
        shards or off-modal widths are left to the per-client fallback."""
        idxs = [self.clients[i].batches(round_rng, batch_size, num_batches)
                for i in client_ids]
        widths = [ix.shape[1] for ix in idxs]
        counts = {}
        for w in widths:
            if w > 0:
                counts[w] = counts.get(w, 0) + 1
        if not counts:
            return None, []
        modal = max(counts, key=lambda w: (counts[w], w))
        rows = [r for r, w in enumerate(widths) if w == modal]
        return np.stack([idxs[r] for r in rows]), rows

    def client_batch_many(self, client_ids, round_rng: int, batch_size: int,
                          num_batches: int):
        """Batched `client_batch`: one device gather for the whole client
        set (the same batches as the per-client calls). Returns (stacked
        batch with leading dim M, rows)."""
        idx, rows = self._client_batch_indices(client_ids, round_rng,
                                               batch_size, num_batches)
        if not rows:
            return None, []
        idx = torch.as_tensor(idx, device=self.device)
        return (self._X_train[idx], self._y_train[idx]), rows

    def eval_batch(self, max_n: int = 2048):
        return self._X_val[:max_n], self._y_val[:max_n]

    @torch.no_grad()
    def accuracy(self, params, max_n: int = 2048) -> float:
        X, y = self.eval_batch(max_n)
        pred = torch.argmax(self.apply(params, X), dim=-1)
        return float((pred == y).float().mean())

    @torch.no_grad()
    def val_loss(self, params, max_n: int = 2048) -> float:
        X, y = self.eval_batch(max_n)
        return float(self.loss(params, (X, y)))
