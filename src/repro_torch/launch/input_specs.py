"""Stand-ins for every model input (the port of `repro.launch.
input_specs`): a shape and a dtype, as the reference's
`jax.ShapeDtypeStruct`, and no memory. Like it, a spec is not checked: a
shape whose sequence is shorter than its image tokens (the agg shapes on
the vision config) has a negative length."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import VISION_DIM


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _spec(shape, dtype):
    return Spec(tuple(shape), dtype)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        st = S - cfg.num_image_tokens
        return {
            "tokens": _spec((B, st), torch.int32),
            "labels": _spec((B, st), torch.int32),
            "image_embeds": _spec((B, cfg.num_image_tokens, VISION_DIM),
                                  torch.float32),
        }
    if cfg.is_encoder_decoder:
        return {
            "tokens": _spec((B, cfg.decoder_prompt), torch.int32),
            "labels": _spec((B, cfg.decoder_prompt), torch.int32),
            "frames": _spec((B, S, cfg.d_model), torch.float32),
        }
    return {
        "tokens": _spec((B, S), torch.int32),
        "labels": _spec((B, S), torch.int32),
    }


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    specs = train_batch_specs(cfg, shape)
    specs.pop("labels")
    return specs


def decode_token_spec(cfg: ModelConfig, shape: ShapeConfig):
    return _spec((shape.global_batch, 1), torch.int32)


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether this (arch, shape) pair runs: long_500k needs a decode
    state that does not grow with the sequence."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False
    return True
