"""Mamba2-370M — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=1, num_kv_heads=1,   # attention-free
    d_ff=0,
    vocab_size=50280,
    stages=(StageSpec(("ssm",), 48),),
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    citation="arXiv:2405.21060",
    supports_long_decode=True,
))
