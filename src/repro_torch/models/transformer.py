"""Decoder stack parameters (the port of `repro.models.transformer` as far
as the transformer payload needs it): the dense FFN, `block_init` for
attention blocks and `stage_init`.

A stage is a pattern of block kinds repeated N times. The reference
`vmap`s the block initialiser over the repeats, so every leaf of a stage
carries a leading repeat axis; `stage_init` stacks the repeats the same
way, and a caller takes layer l with `select(axis, l)` on each leaf. MoE,
SSM, RG-LRU, cross-attention blocks, the stage's forward and decode come
with the zoo slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (CROSS_ATTN, RECURRENT, SSM,
                                      ModelConfig, StageSpec)
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.tree import tree_map


def _ffn_init(generator: torch.Generator, cfg: ModelConfig):
    return {"norm": L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg)),
            "mlp": L.mlp_init(generator, cfg)}


def block_init(generator: torch.Generator, cfg: ModelConfig, kind: str):
    if kind in (SSM, RECURRENT, CROSS_ATTN):
        raise NotImplementedError(f"{kind!r} blocks come with the zoo slice")
    return {"attn": A.attention_init(generator, cfg, kind),
            "ffn": _ffn_init(generator, cfg)}


def stage_init(generator: torch.Generator, cfg: ModelConfig,
               spec: StageSpec):
    """One tree per repeat ({"pos<j>": block}), stacked leafwise on a
    leading repeat axis."""
    reps = [{f"pos{j}": block_init(generator, cfg, kind)
             for j, kind in enumerate(spec.pattern)}
            for _ in range(spec.repeats)]
    return tree_map(lambda *leaves: torch.stack(leaves), *reps)
