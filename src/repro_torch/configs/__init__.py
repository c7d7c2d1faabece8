"""Model configurations of the port (counterpart of ``repro.configs``):
the ``ModelConfig`` schema and every entry of the reference's registry."""
from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .registry import ARCHS, get_config

__all__ = ["ARCHS", "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_config"]
