"""Satellite-side local training (paper eq. 3): E SGD steps from the last
received global model; the update g_k = w_k^E - w_k^0 is held until the next
ground-station contact.

Two entry points share one update body: `make_client_update` (one satellite
per call) and `make_batched_client_update` (a stack of satellites per call
— the engine's aggregation hot path). The batched form writes the
satellite axis out as a leading batch dimension of the parameters: each
step differentiates the sum of the per-satellite losses, whose gradient
with respect to satellite m's parameters is satellite m's own gradient.
A `trainable_mask` (a tree of floats shaped like the parameters' tree, the
DenseNet adapter's frozen-block mask) multiplies each gradient before the
SGD step, so a leaf masked by 0 keeps its value and its delta is exactly
0.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

_LATER = "uplink compression comes with the compression slice of the port"


def _make_update_fn(adapter, *, lr: float, trainable_mask=None):
    masks = None if trainable_mask is None else tree_leaves(trainable_mask)

    def update_fn(params, batches, *, step_axis: int = 0, out=None):
        """params: tree of tensors (with a leading satellite axis when
        batched); batches: tuple of tensors whose `step_axis` indexes the E
        local steps. Returns the delta w^E - w^0, written into `out` (a
        tree of tensors of the params' shapes, e.g. views of rows of the
        engine's update buffer) when given."""
        leaves, structure = tree_flatten(params)
        for e in range(batches[0].shape[step_axis]):
            batch = tuple(b.select(step_axis, e) for b in batches)
            leaves = [w.detach().requires_grad_(True) for w in leaves]
            loss = adapter.loss(tree_unflatten(structure, leaves),
                                batch).sum()
            grads = torch.autograd.grad(loss, leaves)
            if masks is not None:
                grads = [g * m for g, m in zip(grads, masks)]
            with torch.no_grad():
                leaves = [w - lr * g for w, g in zip(leaves, grads)]
        final = tree_unflatten(structure, leaves)
        if out is None:
            return tree_map(lambda w, w0: w - w0, final, params)
        return tree_map(lambda w, w0, o: torch.sub(w, w0, out=o), final,
                        params, out)

    return update_fn


def make_client_update(adapter, *, local_steps: int, lr: float,
                       trainable_mask=None):
    """Returns update_fn(base_params, client_idx, round_rng) -> g_k
    (tree delta)."""
    update_fn = _make_update_fn(adapter, lr=lr,
                                trainable_mask=trainable_mask)

    def client_update(base_params, client_idx: int, round_rng: int,
                      batch_size: int = 32):
        batch = adapter.client_batch(client_idx, round_rng, batch_size,
                                     local_steps)
        if batch is None:      # satellite with an empty shard
            return tree_map(torch.zeros_like, base_params)
        return update_fn(base_params, batch)

    return client_update


def make_batched_client_update(adapter, *, local_steps: int, lr: float,
                               trainable_mask=None, uplink_topk: float = 0.0,
                               uplink_int8: bool = False):
    """Returns update_many(base_params, batches, out=None) -> stacked g_k.

    `batches` is the per-satellite batch tuple stacked on a leading axis M
    (then the E local steps); the base model is shared and broadcast to
    the M satellites. With `out` (a tree of (M, *shape) tensors) the
    deltas are written there and `out` is returned."""
    if uplink_topk or uplink_int8:
        raise NotImplementedError(_LATER)
    update_fn = _make_update_fn(adapter, lr=lr,
                                trainable_mask=trainable_mask)

    def update_many(base_params, batches, out=None):
        m = batches[0].shape[0]
        stacked = tree_map(lambda v: v.expand(m, *v.shape).clone(),
                           base_params)
        return update_fn(stacked, batches, step_axis=1, out=out)

    return update_many
