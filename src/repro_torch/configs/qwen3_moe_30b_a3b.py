"""Qwen3-MoE-30B-A3B — 128 experts, top-8 routing [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32, num_kv_heads=4,
    d_ff=768,                      # per-expert FFN width
    vocab_size=151936,
    stages=(StageSpec(("global",), 48),),
    qk_norm=True,
    head_dim=128,
    num_experts=128,
    experts_per_token=8,
    citation="hf:Qwen/Qwen3-30B-A3B",
))
