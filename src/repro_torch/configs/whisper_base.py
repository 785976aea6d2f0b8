"""Whisper-base — encoder-decoder backbone; conv/mel frontend is a stub that
feeds precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,                  # decoder layers
    d_model=512,
    num_heads=8, num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    stages=(StageSpec(("cross",), 6),),
    encoder_layers=6,
    encoder_seq=1500,
    decoder_prompt=448,
    mlp_act="gelu",
    frontend="audio",
    is_encoder_decoder=True,
    citation="arXiv:2212.04356",
))
