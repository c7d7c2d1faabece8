"""CIM-aware dense layer (counterpart of ``repro.nn.linear``): one entry
point for every stored-weight matmul.

``linear_specs`` gives the weight and, when CIM quantization is on, the
paper's learnable scales (s_w at weight granularity, s_p at psum
granularity, s_a for activations). On a packed backend the weight exists
only as digit planes: ``w_digits`` (nibble uint8 rows for the standard
int4 pack) and its ``w_occ`` occupancy map, in the backend's plane
geometry. ``apply_linear`` dispatches to the plain matmul or the CIM
forward.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.cim_linear import CIMConfig, _linear_forward

from .module import ParamSpec


def linear_specs(k: int, n: int, *, cim: Optional[CIMConfig] = None,
                 in_axis: Optional[str] = None,
                 out_axis: Optional[str] = None, dtype=torch.float32,
                 init: str | None = None) -> Dict[str, ParamSpec]:
    from repro_torch.api.backends import (has_own_pack, is_packed, plane_bits,
                                          plane_tiling)  # api builds on nn
    from repro_torch.core.granularity import Granularity
    from repro_torch.core.nibble import stored_rows
    packed = is_packed(cim)
    if packed:
        t = plane_tiling(cim, k, n)
        own_pack = has_own_pack(cim)
        if own_pack:
            # plane-geometry backends (binary) keep dense plane storage
            rows_s, store = t.array_rows, cim.store_dtype()
        else:
            rows_s, store = stored_rows(t.array_rows, cim.store_dtype())
        specs = {"w_digits": ParamSpec((t.n_split, t.k_tiles, rows_s, n),
                                       store, "zeros",
                                       (None, None, None, out_axis))}
        if not own_pack:
            specs["w_occ"] = ParamSpec((t.n_split, t.k_tiles, n), torch.uint8,
                                       "zeros", (None, None, out_axis))
    else:
        specs = {"w": ParamSpec((k, n), dtype, init or "fan_in:1.0",
                                (in_axis, out_axis))}
    if cim is not None and cim.enabled:
        if packed and plane_bits(cim) != (cim.weight_bits, cim.cell_bits):
            # plane-geometry backends store full column-granularity scales
            t = plane_tiling(cim, k, n)
            wg = t.weight_scale_shape(Granularity.COLUMN)
            pg = t.psum_scale_shape(Granularity.COLUMN)
        else:
            t = cim.tiling(k, n)
            wg = t.weight_scale_shape(cim.weight_granularity)
            pg = t.psum_scale_shape(cim.psum_granularity)
        specs["s_w"] = ParamSpec(wg, torch.float32, "const:0.05",
                                 (None, out_axis if wg[1] == n else None))
        specs["s_p"] = ParamSpec(pg, torch.float32, "const:8.0",
                                 (None, None, out_axis if pg[2] == n else None))
        specs["s_a"] = ParamSpec((1,), torch.float32, "ones", (None,))
    return specs


def apply_linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 cim: Optional[CIMConfig] = None, *,
                 compute_dtype=torch.bfloat16, variation=None,
                 variation_std=None) -> torch.Tensor:
    """x (..., K) -> (..., N): a plain matmul in ``compute_dtype`` without
    CIM, else the CIM forward of ``cim.mode``'s backend."""
    if cim is None or not cim.enabled:
        return x.to(compute_dtype) @ params["w"].to(compute_dtype)
    return _linear_forward(x, params, cim, variation=variation,
                           variation_std=variation_std,
                           compute_dtype=compute_dtype)
