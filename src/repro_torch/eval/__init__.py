"""Evaluation harnesses of the port (counterpart of ``repro.eval``).

``robustness`` is the Monte-Carlo cell-variation and drift sweep
(paper §IV-E / Fig. 10) on the packed backends, with per-layer error
attribution. ``recalibrate`` is in-service recalibration (DESIGN.md
§11): probe-based re-fitting of the column-wise scales against an
observed (drifted) chip, shipped as a versioned ``ScaleDelta`` applied to
a ``DeployArtifact`` without touching its digit planes.
"""
from .recalibrate import (ScaleDelta, apply_scale_delta,
                          apply_scale_delta_params, fit_scale_delta,
                          node_gain)
from .robustness import (LayerAttribution, RobustnessSweep,
                         monte_carlo_linear_error, monte_carlo_resnet,
                         per_layer_attribution)

__all__ = [
    "LayerAttribution", "RobustnessSweep", "ScaleDelta",
    "apply_scale_delta", "apply_scale_delta_params", "fit_scale_delta",
    "monte_carlo_linear_error", "monte_carlo_resnet", "node_gain",
    "per_layer_attribution",
]
