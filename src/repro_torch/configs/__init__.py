"""Model configs: the architecture dataclass, input shapes and registry."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    get_shape,
    smoke_variant,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "get_shape",
    "smoke_variant",
]
