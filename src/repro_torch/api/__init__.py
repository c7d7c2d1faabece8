"""Public CIM-layer API of the port (counterpart of ``repro.api``): the
functional layer lifecycle on explicit param dicts, the backend registry
and whole-model packing."""
from repro_torch.core.cim_conv import _calibrate_conv as calibrate_conv
from repro_torch.core.cim_conv import _conv_forward as conv2d
from repro_torch.core.cim_conv import _init_conv as init_conv
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.core.cim_linear import _calibrate_linear as calibrate_linear
from repro_torch.core.cim_linear import _init_linear as init_linear
from repro_torch.core.cim_linear import _linear_forward as linear

from .artifact import _packed_config, pack_model
from .backends import (Backend, get_backend, packers_for, register_backend,
                       registered_backends)


def pack_linear(params, cfg):
    """Pack trainable linear params with ``cfg``'s backend packer."""
    pack_lin, _ = packers_for(_packed_config(cfg))
    return pack_lin(params, cfg)


def pack_conv(params, cfg):
    """Pack trainable conv params with ``cfg``'s backend packer."""
    _, pack_cv = packers_for(_packed_config(cfg))
    return pack_cv(params, cfg)


__all__ = [
    "Backend", "CIMConfig", "calibrate_conv", "calibrate_linear", "conv2d",
    "get_backend", "init_conv", "init_linear", "linear", "pack_conv",
    "pack_linear", "pack_model", "packers_for", "register_backend",
    "registered_backends",
]
