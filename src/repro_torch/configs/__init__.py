from .base import (ARCH_IDS, PORTED_ARCHS, SHAPES, ModelConfig, ShapeCell,
                   get_config, list_archs, require_ported)

__all__ = ["ARCH_IDS", "PORTED_ARCHS", "SHAPES", "ModelConfig", "ShapeCell",
           "get_config", "list_archs", "require_ported"]
