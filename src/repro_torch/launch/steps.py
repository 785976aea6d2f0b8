"""Serving step functions of the model zoo (the port of
`repro.launch.steps`' prefill and decode steps): prefill, the greedy serve
step, and the decode state's shapes.

The steps run on the device their params are on (`transformer.
init_params(seed, cfg)` draws them on the card by default), under
`torch.inference_mode()`. The reference's shardings, its train step and
its aggregation steps come with ROADMAP A.11 part 2.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T


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
    device: its tensors carry shapes and dtypes and hold no memory."""
    return T.init_decode_state(None, cfg, shape.global_batch, shape.seq_len,
                               getattr(torch, cfg.param_dtype),
                               device="meta")


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, state, token (B, 1)) -> (greedy next token
    (B, 1) int32, new state)."""
    def serve_step(params, state, token):
        with torch.inference_mode():
            logits, state = T.decode_step(params, token, state, cfg)
            next_token = torch.argmax(logits[:, -1, :], dim=-1)
            return next_token.to(torch.int32)[:, None], state

    return serve_step
