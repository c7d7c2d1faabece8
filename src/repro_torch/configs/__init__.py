"""Model configurations of the port (counterpart of ``repro.configs``):
the ``ModelConfig`` schema and the registry entries ported so far."""
from .base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from .registry import ARCHS, get_config

__all__ = ["ARCHS", "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_config"]
