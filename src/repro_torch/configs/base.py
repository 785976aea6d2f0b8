"""Model configuration: `StageSpec`, `ModelConfig` and the block kinds, a
copy of `repro.configs.base` as far as the port's models use it (the
port keeps its own copy rather than importing the reference). The arch
registry, `ShapeConfig` and `ModelConfig.reduced` come with the zoo slice.
Configs are frozen dataclasses, so they hash.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds usable in a layer pattern.
GLOBAL_ATTN = "global"      # full causal attention
LOCAL_ATTN = "local"        # sliding-window causal attention
RECURRENT = "recurrent"     # RG-LRU recurrent block
SSM = "ssm"                 # Mamba-2 SSD block
ENC_ATTN = "enc"            # bidirectional encoder self-attention
CROSS_ATTN = "cross"        # decoder layer with self(causal) + cross attention


@dataclass(frozen=True)
class StageSpec:
    """A group of layers: ``pattern`` repeated ``repeats`` times, with the
    parameters stacked on a leading repeat axis."""
    pattern: Tuple[str, ...]
    repeats: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class ModelConfig:
    """The fields of `repro.configs.base.ModelConfig` that the port's
    models read, with the reference's names and defaults; the others (MoE,
    SSM, RG-LRU, encoder-decoder, frontends, vocabulary) come with the
    slices that read them."""
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    stages: Tuple[StageSpec, ...] = ()
    head_dim: Optional[int] = None
    qk_norm: bool = False
    mlp_act: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return (self.head_dim if self.head_dim
                else self.d_model // self.num_heads)

    def validate(self) -> None:
        assert sum(s.num_layers for s in self.stages) == self.num_layers, (
            self.name, sum(s.num_layers for s in self.stages), self.num_layers)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
