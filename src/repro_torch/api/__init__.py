"""Public CIM-layer API of the port (counterpart of ``repro.api``): the
functional layer lifecycle on explicit param dicts, the layer handles
``QuantLinear``/``QuantConv2d``, the backend registry, whole-model packing
and the ``DeployArtifact`` with its save and load.

``linear`` and ``conv2d`` take ``variation`` (a theta tensor over the
logical packed layout, or a ``Sampler``) and ``variation_std`` to evaluate
one cell-noise realization; ``pack_linear`` and ``pack_conv`` can bake one
into the planes."""
from repro_torch.core.cim_conv import _calibrate_conv as calibrate_conv
from repro_torch.core.cim_conv import _conv_forward as conv2d
from repro_torch.core.cim_conv import _init_conv as init_conv
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.core.cim_linear import _calibrate_linear as calibrate_linear
from repro_torch.core.cim_linear import _init_linear as init_linear
from repro_torch.core.cim_linear import _linear_forward as linear
from repro_torch.core.variation import Sampler

from .artifact import (ARTIFACT_LAYOUT_VERSION, SCALE_DELTA_VERSION,
                       ArtifactVersionError, DeployArtifact, _packed_config,
                       col_shard_axes, model_artifact, pack_model)
from .backends import (Backend, conv_plane_tiling, get_backend, has_own_pack,
                       is_packed, packers_for, plane_bits, plane_tiling,
                       register_backend, registered_backends)
from .handles import QuantConv2d, QuantLinear, Variation


def pack_linear(params, cfg, *, variation=None, variation_std=None):
    """Pack trainable linear params with ``cfg``'s backend packer;
    ``variation`` bakes one device realization into the planes."""
    pack_lin, _ = packers_for(_packed_config(cfg))
    return pack_lin(params, cfg, variation=variation,
                    variation_std=variation_std)


def pack_conv(params, cfg, *, variation=None, variation_std=None):
    """Pack trainable conv params with ``cfg``'s backend packer;
    ``variation`` bakes one device realization into the planes."""
    _, pack_cv = packers_for(_packed_config(cfg))
    return pack_cv(params, cfg, variation=variation,
                   variation_std=variation_std)


__all__ = [
    "ARTIFACT_LAYOUT_VERSION", "ArtifactVersionError", "Backend",
    "CIMConfig", "DeployArtifact", "QuantConv2d", "QuantLinear",
    "SCALE_DELTA_VERSION", "Sampler", "Variation", "calibrate_conv",
    "calibrate_linear", "col_shard_axes", "conv2d", "conv_plane_tiling",
    "get_backend", "has_own_pack", "init_conv", "init_linear", "is_packed",
    "linear", "model_artifact", "pack_conv", "pack_linear", "pack_model",
    "packers_for", "plane_bits", "plane_tiling", "register_backend",
    "registered_backends",
]
