"""Phi-3-Vision-4.2B — phi3-mini decoder + CLIP vision stub
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32, num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    stages=(StageSpec(("global",), 32),),
    frontend="vision",
    num_image_tokens=576,
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
))
