"""Configuration system: model configs, input shapes and the arch registry,
a copy of `repro.configs.base` (the port keeps its own copy rather than
importing the reference).

Every architecture registers a ``ModelConfig`` here through its
``src/repro_torch/configs/<id>.py`` module, which holds the same data as
the reference's. Configs are frozen dataclasses, so they hash.
"""
from __future__ import annotations

import dataclasses
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
    """The reference's fields, names and defaults. `arch_type` and
    `vocab_size` have none there; here they default to a dense stack
    without a vocabulary (the transformer payload's), so they follow the
    required fields and the config is built by keyword."""
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio | cnn
    vocab_size: int = 0
    # --- architecture of the stack ---
    stages: Tuple[StageSpec, ...] = ()
    head_dim: Optional[int] = None
    window_size: int = 4096           # for LOCAL_ATTN layers
    qk_norm: bool = False
    mlp_act: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- SSM (mamba2) ---
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- RG-LRU (recurrentgemma) ---
    lru_width: int = 0
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500           # nominal frame count of the audio stub
    decoder_prompt: int = 448         # decoder token budget for train/prefill
    # --- modality frontends (stubs) ---
    frontend: Optional[str] = None    # None | "vision" | "audio"
    num_image_tokens: int = 576       # vision stub patch-embedding count
    # --- numerics ---
    param_dtype: str = "bfloat16"
    # --- provenance ---
    citation: str = ""
    # --- capability flags ---
    supports_long_decode: bool = False   # sub-quadratic decode state?
    is_encoder_decoder: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return (self.head_dim if self.head_dim
                else self.d_model // self.num_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        out = []
        for st in self.stages:
            out.extend(list(st.pattern) * st.repeats)
        return tuple(out)

    def validate(self) -> None:
        assert sum(s.num_layers for s in self.stages) == self.num_layers, (
            self.name, sum(s.num_layers for s in self.stages), self.num_layers)
        if self.num_experts:
            assert self.experts_per_token > 0
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (<=2 layers,
        d_model<=512, <=4 experts)."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = min(self.num_kv_heads, max(1, num_heads // 2))
        num_kv = num_heads // max(1, num_heads // num_kv)
        # Keep one repeat of each stage pattern, at most 2 layers total.
        stages = []
        total = 0
        for st in self.stages:
            pat = st.pattern[: max(1, 2 - total)]
            if not pat:
                break
            stages.append(StageSpec(pattern=tuple(pat), repeats=1))
            total += len(pat)
            if total >= 2:
                break
        kw = dict(
            name=self.name + "-smoke",
            num_layers=sum(s.num_layers for s in stages),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=max(1, num_kv),
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            stages=tuple(stages),
            head_dim=None,
            window_size=min(self.window_size, 64),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state_dim=min(self.ssm_state_dim, 16),
            ssm_head_dim=min(self.ssm_head_dim, 16),
            ssm_chunk=32,
            lru_width=min(self.lru_width, d_model),
            encoder_layers=min(self.encoder_layers, 1),
            encoder_seq=32,
            decoder_prompt=16,
            num_image_tokens=8,
            param_dtype="float32",
        )
        kw.update(overrides)
        cfg = dataclasses.replace(self, **kw)
        cfg.validate()
        return cfg


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
    # beyond the 10x4 grid: the paper's eq. 4 buffered aggregation at
    # datacenter scale (global_batch = buffer size M)
    "agg_m96": ShapeConfig("agg_m96", 0, 96, "agg"),
    # a full FL round: M=16 buffered client rounds replayed + aggregated
    "flround_m16": ShapeConfig("flround_m16", 512, 16, "flround"),
}

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False
_CONFIG_MODULES = [
    "mamba2_370m", "h2o_danube_1_8b", "phi3_vision_4_2b", "qwen3_moe_30b_a3b",
    "qwen3_8b", "gemma3_12b", "recurrentgemma_9b", "minitron_4b",
    "whisper_base", "mixtral_8x7b", "densenet_fl", "qwen3_8b_swa",
]


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for m in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _LOADED = True
