"""Architecture configs of the port (copies of ``repro.configs``)."""
from .base import ARCH_IDS, PORTED, SHAPES, ModelConfig, ShapeConfig, get_config

__all__ = ["ARCH_IDS", "PORTED", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config"]
