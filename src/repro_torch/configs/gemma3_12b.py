"""Gemma3-12B — 5:1 local:global interleave, 128k context
[hf:google/gemma-3-1b-pt family]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16, num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    stages=(StageSpec(("local", "local", "local", "local", "local", "global"), 8),),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    citation="hf:google/gemma-3-1b-pt",
    supports_long_decode=True,
))
