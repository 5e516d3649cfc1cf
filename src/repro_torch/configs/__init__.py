from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    all_cells,
    get_config,
    get_smoke_config,
)
from repro_torch.configs.moses import DEFAULT as MOSES_DEFAULT
from repro_torch.configs.moses import CostModelConfig, MosesConfig

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "all_cells",
    "get_config",
    "get_smoke_config",
    "MOSES_DEFAULT",
    "CostModelConfig",
    "MosesConfig",
]
