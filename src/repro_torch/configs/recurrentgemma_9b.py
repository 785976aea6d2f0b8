"""RecurrentGemma-9B — RG-LRU recurrent blocks + local attention, 2 recurrent
per 1 attention [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16, num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    stages=(
        StageSpec(("recurrent", "recurrent", "local"), 12),
        StageSpec(("recurrent", "recurrent"), 1),
    ),
    window_size=2048,
    lru_width=4096,
    citation="arXiv:2402.19427",
    supports_long_decode=True,
))
