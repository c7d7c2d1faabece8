"""Serving of the port (counterpart of ``repro.serve``): the slot engine
and ``engine_from_artifact``."""
from .engine import (Request, ServingEngine, engine_from_artifact,
                     make_decode_step, make_prefill)

__all__ = ["Request", "ServingEngine", "engine_from_artifact",
           "make_decode_step", "make_prefill"]
