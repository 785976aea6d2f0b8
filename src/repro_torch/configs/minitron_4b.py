"""Minitron-4B — width/depth-pruned Nemotron [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24, num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    stages=(StageSpec(("global",), 32),),
    citation="arXiv:2407.14679",
))
