from .base import ModelConfig
from .registry import ARCH_IDS, get_config, lcma_smoke_config, list_archs, smoke_config

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "smoke_config",
           "lcma_smoke_config", "list_archs"]
