from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    get_config,
    list_configs,
    register,
)
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, get_shape  # noqa: F401
