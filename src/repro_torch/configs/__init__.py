from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    get_smoke_config,
    list_archs,
    reduced,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "reduced",
]
