"""Step functions of the model zoo (the port of `repro.launch.steps`'
train, prefill and decode steps): the train step (AdamW, clipping by the
global norm, microbatches, remat), prefill, the greedy serve step, and
the decode state's shapes.

The steps run on the device their params are on (`transformer.
init_params(seed, cfg)` draws them on the card by default). Prefill and
the serve step run under `torch.inference_mode()`; the train step runs
autograd on the parameter leaves and writes the params and the AdamW
state in place (ROADMAP C20), every leaf of the tree: the encoder's, the
vision projection's and the RG-LRU's too. The serve step writes the
decode state in place (C19): KV caches, SSM and RG-LRU states and a
cross block's self cache. The reference's meshes, shardings and expert
parallelism come with ROADMAP A.10; its `build` and aggregation steps
with A.11 part 2 step 3.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_apply, clip_by_global_norm
from repro_torch.tree import tree_flatten, tree_unflatten


def _no_mesh(mesh, moe_groups: int = 1):
    if mesh is not None or moe_groups == -2:
        raise NotImplementedError(
            "meshes, shardings and expert parallelism (moe_groups=-2) come "
            "with ROADMAP A.10; the port's steps run on one device")


def default_num_micro(cfg: ModelConfig, shape: ShapeConfig,
                      mesh=None) -> int:
    """A microbatch count that gives each data shard ~1 sequence a
    microbatch (bounds activation memory at long sequences); one device
    is one data shard."""
    _no_mesh(mesh)
    return min(max(1, shape.global_batch), 16)


# ---------------------------------------------------------------------------
# Train


def make_loss_and_grad(cfg: ModelConfig, *, num_micro: int = 1,
                       q_chunk: int = 512, aux_weight: float = 0.01,
                       moe_groups: int = 1):
    """loss_and_grad(params, batch) -> (loss, grads): the loss
    `lm_loss + aux_weight * aux` (remat on, as in the reference's step)
    and its gradient in the params' tree, both device tensors. With
    `num_micro` > 1 the batch is split into that many microbatches along
    its first dim; their gradients are added in order into float32 sums,
    and the sums and the loss are divided by `num_micro`, as the
    reference's scan does. With one, the gradients are in the params'
    dtypes."""
    def loss_fn(params, mb):
        logits, aux = T.forward(params, mb, cfg, q_chunk=q_chunk,
                                moe_groups=moe_groups)
        return T.lm_loss(logits, mb["labels"]) + aux_weight * aux

    def loss_and_grad(params, batch):
        leaves, structure = tree_flatten(params)
        live = [p.detach().requires_grad_() for p in leaves]
        tree = tree_unflatten(structure, live)
        if num_micro == 1:
            loss = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, live)
            return loss.detach(), tree_unflatten(structure, list(grads))
        micro = {k: v.reshape(num_micro, v.shape[0] // num_micro,
                              *v.shape[1:]) for k, v in batch.items()}
        sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(num_micro):
            l_i = loss_fn(tree, {k: v[i] for k, v in micro.items()})
            for acc, g in zip(sums, torch.autograd.grad(l_i, live)):
                acc.add_(g)
            loss = loss + l_i.detach()
        for acc in sums:
            acc.div_(num_micro)
        return loss / num_micro, tree_unflatten(structure, sums)

    return loss_and_grad


def make_train_step(cfg: ModelConfig, mesh=None, *, num_micro: int = 1,
                    lr: float = 3e-4, q_chunk: int = 512,
                    aux_weight: float = 0.01, clip_norm: float = 1.0,
                    moe_groups: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"}): the loss and gradient of `make_loss_and_grad`,
    then `update`: the gradient clipped to `clip_norm` by its global norm,
    one AdamW step at `lr`. params and opt_state (`optim.adamw_init`) are
    written in place and returned; the metrics are device tensors, so a
    step reads nothing back. `q_chunk` is accepted and, as in prefill,
    changes nothing (`models/attention.py`). The step's two halves are its
    attributes `loss_and_grad(params, batch)` and `update(params,
    opt_state, grads) -> (opt_state, grad_norm)`, for a profiler that
    times them apart."""
    _no_mesh(mesh, moe_groups)
    loss_and_grad = make_loss_and_grad(
        cfg, num_micro=num_micro, q_chunk=q_chunk, aux_weight=aux_weight,
        moe_groups=max(moe_groups, 1))

    def update(params, opt_state, grads):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        return adamw_apply(grads, opt_state, params, lr), gnorm

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grad(params, batch)
        opt_state, gnorm = update(params, opt_state, grads)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    train_step.loss_and_grad, train_step.update = loss_and_grad, update
    return train_step


# ---------------------------------------------------------------------------
# Prefill and decode


def make_prefill_step(cfg: ModelConfig, *, q_chunk: int = 512,
                      moe_groups: int = 1):
    """prefill_step(params, batch) -> next-token logits (B, V)."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, _ = T.forward(params, batch, cfg, q_chunk=q_chunk,
                                  moe_groups=moe_groups)
            return logits[:, -1, :]

    return prefill_step


def make_decode_state_shape(cfg: ModelConfig, shape: ShapeConfig):
    """The decode state at `shape` (batch, cache length) on the meta
    device: its tensors carry shapes and dtypes and hold no memory. An
    encoder-decoder's comes from frames (batch, encoder_seq, d_model), as
    the reference's."""
    B = shape.global_batch
    frames = (torch.empty((B, cfg.encoder_seq, cfg.d_model), device="meta")
              if cfg.is_encoder_decoder else None)
    return T.init_decode_state(None, cfg, B, shape.seq_len,
                               getattr(torch, cfg.param_dtype),
                               enc_frames=frames, device="meta")


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, state, token (B, 1)) -> (greedy next token
    (B, 1) int32, new state)."""
    def serve_step(params, state, token):
        with torch.inference_mode():
            logits, state = T.decode_step(params, token, state, cfg)
            next_token = torch.argmax(logits[:, -1, :], dim=-1)
            return next_token.to(torch.int32)[:, None], state

    return serve_step
