"""Model configurations of the port (`repro.configs`): the configs of the
model zoo, registered by name, and the input shapes."""
from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeConfig,
                                      StageSpec, get_config, list_configs,
                                      register)
