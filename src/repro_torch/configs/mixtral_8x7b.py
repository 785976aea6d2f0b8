"""Mixtral-8x7B — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32, num_kv_heads=8,
    d_ff=14336,                    # per-expert FFN width
    vocab_size=32000,
    stages=(StageSpec(("local",), 32),),
    window_size=4096,
    num_experts=8,
    experts_per_token=2,
    citation="arXiv:2401.04088",
    supports_long_decode=True,
))
