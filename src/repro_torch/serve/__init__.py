"""Serving of the port (counterpart of ``repro.serve``): the slot engine,
``engine_from_artifact``, and the drift monitor of self-healing
serving."""
from .engine import (ServingEngine, engine_from_artifact, make_decode_step,
                     make_prefill)
from .health import DriftMonitor, HealthConfig, logit_stats, tap_stats

__all__ = ["DriftMonitor", "HealthConfig", "ServingEngine",
           "engine_from_artifact", "logit_stats", "make_decode_step",
           "make_prefill", "tap_stats"]
