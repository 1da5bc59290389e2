from .base import SHAPE_CELLS, ModelConfig, ShapeCell
from .registry import ARCH_IDS, get_config, lcma_smoke_config, list_archs, smoke_config

__all__ = ["ModelConfig", "ShapeCell", "SHAPE_CELLS", "ARCH_IDS", "get_config", "smoke_config",
           "lcma_smoke_config", "list_archs"]
