"""Qwen3-8B — dense GQA decoder with qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32, num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    stages=(StageSpec(("global",), 36),),
    qk_norm=True,
    citation="hf:Qwen/Qwen3-8B",
))
