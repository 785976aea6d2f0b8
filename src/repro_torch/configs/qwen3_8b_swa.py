"""Qwen3-8B-SWA — beyond-paper sliding-window retrofit of qwen3-8b so a pure
full-attention dense arch can exercise long_500k decode (see DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="qwen3-8b-swa",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32, num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    stages=(StageSpec(("local",), 36),),
    window_size=4096,
    qk_norm=True,
    citation="hf:Qwen/Qwen3-8B (windowed variant, ours)",
    supports_long_decode=True,
))
