from repro_torch.configs.base import (
    INPUT_SHAPES,
    PORTED_ARCHS,
    ModelConfig,
    ShapeConfig,
    get_config,
    get_shape,
    get_smoke_config,
)

__all__ = [
    "INPUT_SHAPES",
    "PORTED_ARCHS",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "get_shape",
    "get_smoke_config",
]
