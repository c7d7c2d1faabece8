"""Core library of the port: column-wise weight and partial-sum
quantization for CIM accelerators, in PyTorch (counterpart of
``repro.core``)."""
from .bitsplit import place_values, recombine, split_digits
from .cim_linear import CIMConfig, deploy_act_codes, weight_scales_from
from .granularity import ArrayTiling, Granularity, conv_tiling, n_splits
from .nibble import (can_pack_nibbles, is_nibble_packed, occupancy_map,
                     pack_nibbles, stored_rows, unpack_nibbles)
from .quantizer import init_scale_from, lsq_fake_quant, lsq_integer, qrange

__all__ = [
    "ArrayTiling", "CIMConfig", "Granularity", "can_pack_nibbles",
    "conv_tiling", "deploy_act_codes", "init_scale_from", "is_nibble_packed",
    "lsq_fake_quant", "lsq_integer", "n_splits", "occupancy_map",
    "pack_nibbles", "place_values", "qrange", "recombine", "split_digits",
    "stored_rows", "unpack_nibbles", "weight_scales_from",
]
