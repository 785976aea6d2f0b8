"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32, num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    stages=(StageSpec(("local",), 24),),
    window_size=4096,
    citation="arXiv:2401.16818",
    supports_long_decode=True,
))
