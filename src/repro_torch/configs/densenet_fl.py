"""The paper's own FL model: a compact DenseNet-style CNN for fMoW-like
62-class image classification (DenseNet-161 in the paper; see DESIGN.md §7).

Handled by repro_torch.models.densenet, not the transformer stack; registered here
so --arch densenet-fl selects it in the FL drivers.
"""
from repro_torch.configs.base import ModelConfig, StageSpec, register

register(ModelConfig(
    name="densenet-fl",
    arch_type="cnn",
    num_layers=4,                  # dense blocks
    d_model=64,                    # growth rate
    num_heads=1, num_kv_heads=1,
    d_ff=0,
    vocab_size=62,                 # classes
    stages=(StageSpec(("cnn",), 4),),
    citation="Huang et al. 2017 (DenseNet); So et al. 2022 (FedSpace setup)",
))
