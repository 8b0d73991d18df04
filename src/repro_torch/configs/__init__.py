from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_cells,
    get_config,
    get_smoke_config,
    scaled,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_cells",
    "get_config",
    "get_smoke_config",
    "scaled",
]
