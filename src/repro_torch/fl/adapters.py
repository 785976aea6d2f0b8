"""Model adapters: bind a model family to the FL engine (init/loss/eval +
deterministic client batches). Parameters are (nested) dicts of tensors on
the adapter's device, mirroring the reference's pytrees key for key.

The port of `repro.fl.adapters`: the quickstart's MLP adapter, the
paper's DenseNet adapter (with its frozen-block mask), and the transformer
payload adapter, whose RMSNorm and attention run in the port's kernels.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, StageSpec
from repro_torch.data.fmow import NUM_CLASSES, SyntheticFmow
from repro_torch.data.pipeline import ClientDataset
from repro_torch.fl.registry import register_adapter
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_op
from repro_torch.models import attention as A
from repro_torch.models import densenet as DN
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.tree import tree_map


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


@register_adapter("densenet")
class DenseNetFmowAdapter(MlpFmowAdapter):
    """The paper's model family: a DenseNet-style CNN over the (H, W, 3)
    images, with an optional frozen prefix (transfer learning, §4.1).

    Every train image is rendered once when the adapter is built (each
    sample's noise is seeded by its index, so the rendering is the
    reference's per-batch one, bit for bit) and held on the device, where
    the MLP adapter's batch plumbing gathers the client batches. The
    convolutions are cuDNN's on the card, in full float32 and with a
    fixed algorithm: TF32 is switched off for convolutions and matmuls,
    and cuDNN is made deterministic (no benchmark-chosen algorithms), so
    the card computes the reference's float32 products and two runs on it
    agree bit for bit."""

    name = "densenet"

    def __init__(self, data: SyntheticFmow, clients: List[ClientDataset],
                 growth: int = 8, blocks=(2, 2, 2), stem: int = 16,
                 frozen_blocks: int = 0, val_n: int = 1024, *, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.data = data
        self.clients = clients
        self.growth, self.blocks, self.stem = growth, tuple(blocks), stem
        self.frozen_blocks = frozen_blocks
        self.device = torch.device(device)
        self._X_train = torch.as_tensor(
            data.images(np.arange(data.spec.num_train), "train"),
            device=self.device)
        self._y_train = torch.as_tensor(data.train_labels,
                                        device=self.device)
        n_val = min(val_n, data.spec.num_val)
        self._X_val = torch.as_tensor(data.images(np.arange(n_val), "val"),
                                      device=self.device)
        self._y_val = torch.as_tensor(data.val_labels[:n_val],
                                      device=self.device)

    def init(self, generator: torch.Generator):
        """Random initial model drawn from `generator` (CPU), with the
        reference's tree: the same keys, shapes and layouts, other numbers
        (see `repro_torch.weights`)."""
        params = DN.densenet_init(generator, num_classes=NUM_CLASSES,
                                  growth=self.growth, blocks=self.blocks,
                                  stem=self.stem)
        return tree_map(lambda t: t.to(self.device), params)

    def trainable_mask(self, params):
        return DN.frozen_mask(params, self.frozen_blocks)

    def apply(self, params, X):
        return DN.densenet_apply(params, X)

    # the reference evaluates on the first 1024 validation images at most,
    # so the utility sampler's batched loss sees the batch `val_loss` does
    def eval_batch(self, max_n: int = 1024):
        return super().eval_batch(max_n)

    def accuracy(self, params, max_n: int = 1024) -> float:
        return super().accuracy(params, max_n)

    def val_loss(self, params, max_n: int = 1024) -> float:
        return super().val_loss(params, max_n)


@register_adapter("transformer")
class TransformerFmowAdapter(MlpFmowAdapter):
    """Real payload on the wire: a small decoder stack (GQA attention with
    RoPE, swiglu FFN, pre-norm) classifying each fMoW feature vector as a
    token sequence. Its RMSNorms and its attention run in the port's
    kernels (`kernels/rmsnorm`, `kernels/flash_attention`: CUDA kernels
    with a CUDA backward on the card, their plain versions on the CPU);
    the projections stay `torch.matmul`s, as the reference leaves them to
    XLA, with TF32 off. Data plumbing (client batches, eval slices) is the
    MLP adapter's.

    `apply` takes the parameters with or without a leading satellite
    axis (the batched client update's): stage leaves are then (M, L, ...)
    and layer l is taken on axis 1."""

    name = "transformer"

    def __init__(self, data: SyntheticFmow, clients: List[ClientDataset],
                 d_model: int = 32, num_layers: int = 2, num_heads: int = 4,
                 num_kv_heads: int = 2, d_ff: int = 64, seq_len: int = 8, *,
                 device):
        super().__init__(data, clients, device=device)
        F = self._X_train.shape[1]
        # the feature vector is read as a sequence of S tokens of width
        # F/S; S is the largest value <= seq_len that divides F
        S = min(seq_len, F)
        while F % S:
            S -= 1
        self.seq_len = S
        self.cfg = ModelConfig(
            name="fl-transformer", num_layers=num_layers, d_model=d_model,
            num_heads=num_heads, num_kv_heads=num_kv_heads, d_ff=d_ff,
            stages=(StageSpec(("global",), num_layers),),
            param_dtype="float32")
        self.cfg.validate()

    def init(self, generator: torch.Generator):
        """Random initial model drawn from `generator` (CPU), with the
        reference's tree: the same keys and shapes, other numbers (see
        `repro_torch.weights`)."""
        cfg = self.cfg
        F, S = self._X_train.shape[1], self.seq_len
        params = {
            "w_in": L.dense_init(generator, F // S, cfg.d_model,
                                 torch.float32),
            "stage": TF.stage_init(generator, cfg, cfg.stages[0]),
            "final_norm": L.rmsnorm_init(cfg.d_model, torch.float32),
            "head_w": L.dense_init(generator, cfg.d_model, NUM_CLASSES,
                                   torch.float32),
            "head_b": torch.zeros(NUM_CLASSES),
        }
        return tree_map(lambda t: t.to(self.device), params)

    def apply(self, params, X):
        cfg = self.cfg
        lead = X.shape[:-2]                 # () or (M,) satellites
        B, S = X.shape[-2], self.seq_len
        H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        x = L.linear(X.reshape(*lead, B, S, -1), params["w_in"])
        positions = torch.arange(S, device=X.device)
        for layer in range(cfg.stages[0].repeats):
            rep = tree_map(lambda a: a.select(len(lead), layer),
                           params["stage"])
            # pre-norm attention + residual, with the normalisation and
            # the attention itself in the kernels
            a = rep["pos0"]["attn"]
            hn = rmsnorm_op(x, a["norm"]["scale"], cfg.norm_eps)
            q, k, v = A._project_qkv(a, hn, cfg, positions)
            o = flash_attention_bshd(q.reshape(-1, S, H, hd),
                                     k.reshape(-1, S, K, hd),
                                     v.reshape(-1, S, K, hd), causal=True)
            x = x + L.linear(o.reshape(*lead, B, S, H * hd), a["wo"])
            f = rep["pos0"]["ffn"]
            hn = rmsnorm_op(x, f["norm"]["scale"], cfg.norm_eps)
            x = x + L.mlp_apply(f["mlp"], hn, cfg.mlp_act)
        x = rmsnorm_op(x, params["final_norm"]["scale"], cfg.norm_eps)
        return (L.linear(x[..., -1, :], params["head_w"])
                + params["head_b"].unsqueeze(-2))
