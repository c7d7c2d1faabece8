"""Model configurations of the port (counterpart of ``repro.configs``):
the ``ModelConfig``, ``Shape`` and ``RunConfig`` schemas and every entry
of the reference's registry."""
from .base import (SHAPES, MLAConfig, ModelConfig, MoEConfig, RunConfig,
                   Shape, SSMConfig)
from .registry import ARCHS, all_cells, cell_status, get_config

__all__ = ["ARCHS", "MLAConfig", "ModelConfig", "MoEConfig", "RunConfig",
           "SHAPES", "SSMConfig", "Shape", "all_cells", "cell_status",
           "get_config"]
