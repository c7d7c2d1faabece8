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

from repro_torch.core import colshard
from repro_torch.core.cim_linear import CIMConfig, _linear_forward

from .module import ParamSpec, batch_parallel, batch_ranks


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
    CIM, else the CIM forward of ``cim.mode``'s backend. A raw weight
    placed over a mesh (``nn.module.shard_params``), or any raw layer
    inside a data parallel step, takes ``_placed_linear``."""
    if "w" in params and (any(colshard.is_col_sharded(v)
                              for v in params.values())
                          or batch_ranks() > 1):
        return _placed_linear(params, x, cim, compute_dtype, variation,
                              variation_std)
    if cim is None or not cim.enabled:
        return x.to(compute_dtype) @ params["w"].to(compute_dtype)
    return _linear_forward(x, params, cim, variation=variation,
                           variation_std=variation_std,
                           compute_dtype=compute_dtype)


def _placed_linear(params, x, cim, compute_dtype, variation,
                   variation_std):
    """A raw linear under its placements, off or under CIM emulate.

    FSDP's splits (the embed axis over the batch axes) are gathered first
    (``colshard.unshard_batch``; a no-op where the layer loop has gathered
    them). Then ``w``'s split over ``"model"`` picks the path:

    - none: the plain forward on the whole weight;
    - column-parallel (``out_axis`` over ``"model"``: wq, wk, wv, wg, wu,
      the LM head): the rank computes its columns -- under emulate its
      columns' partial sums, ADC and shift-and-add, with its columns of
      ``s_w`` and ``s_p`` (placed with the weight, or cut from replicated
      tile-level scales) -- and one gather over ``"model"`` joins them
      (the packed column-parallel dispatch of ``kernels.ops`` does the
      same on the kernel). The input
      enters through ``colshard.grad_psum`` (off: ``colshard.col_matmul``):
      each rank's gradient covers its columns only, and the parts are
      summed in float32;
    - row-parallel (``in_axis`` over ``"model"``: wo, wd): each rank
      computes its rows' partial product and one sum over ``"model"``
      (``colshard.psum``) adds them. Under emulate the ADC quantizes each
      whole array tile's partial sum, so a rank must hold whole tiles:
      where its rows start and end on tile boundaries (K / ranks a
      multiple of ``array_rows``) it takes its ``k_tiles`` slice of the
      replicated ``s_w``/``s_p`` (``colshard.split``: their gradient is
      the ranks' tile slices gathered, each summed once) and the ranks'
      shift-added tile outputs are summed; where it does not (the reduced
      llama3's ``wd``, 160 rows on 32-row arrays: 80 a rank), the weight
      is gathered whole at use (``colshard.whole``) and every rank runs
      the whole layer.

    Inside a data parallel step LSQ's g counts the global batch
    (``nn.module.batch_ranks``). Cell variation needs the whole planes'
    draw and is refused here."""
    from repro_torch.core import cim_linear as cl
    from repro_torch.obs import adc as obs_adc
    if variation is not None or variation_std:
        raise ValueError("cell variation on a placed raw linear: the noise "
                         "is drawn over the whole layer; pack it and "
                         "serve it column-parallel")
    if "deq_scale" in params:
        raise ValueError("a recalibration gain (deq_scale) on a placed raw "
                         "linear: recalibrate the packed layer")
    rows = batch_ranks()
    p = colshard.unshard_tree(params)
    emulate = cim is not None and cim.enabled
    if emulate and cim.mode != "emulate":
        raise ValueError(f"a placed raw linear runs off or under emulate, "
                         f"not {cim.mode!r}")
    w = p["w"]
    d = colshard.model_dim(w)
    k, n = w.shape
    if d == 0 and emulate and (k // colshard.mesh_shards(
            w.device_mesh, "model")) % cim.array_rows:
        # split tile: gathered at use, the whole layer on every rank
        p = {kk: colshard.whole(v) for kk, v in p.items()}
        w, d = p["w"], None
    if d is None:
        p = {kk: colshard.whole(v) for kk, v in p.items()}
        if not emulate:
            return x.to(compute_dtype) @ p["w"].to(compute_dtype)
        return cl._forward_emulate(x, p, cim, None, 0.0, compute_dtype,
                                   rows=rows)
    model, mesh = ("model",), w.device_mesh
    w_loc = w.to_local()
    if not emulate:
        if d == 1:
            # per column the single device's product; the input's gradient
            # summed over "model" in float32 (colshard.col_matmul)
            y = colshard.col_matmul(x.to(compute_dtype),
                                    w_loc.to(compute_dtype), mesh, model)
            return colshard.gather(y, mesh, model, -1)
        # the operands rounded to the compute dtype, as one device's GEMM
        # reads them; the ranks' partial products summed in float32 and
        # rounded once, as that GEMM accumulates
        y = colshard.split(x.to(compute_dtype).to(torch.float32), mesh,
                           model, -1) @ w_loc.to(compute_dtype).to(
                               torch.float32)
        return colshard.psum(y, mesh, model).to(compute_dtype)
    t = cim.tiling(k, n)
    a_int, s_a = cl._quantize_act(x, p, cim, rows)
    s_w, s_p = t.broadcast_weight_scale, t.broadcast_psum_scale
    partial = model + (batch_parallel()[1] if rows > 1 else ())
    if d == 1:
        s_w = _cols(p["s_w"], s_w, mesh, -1)
        s_p = _cols(p["s_p"], s_p, mesh, -1)
        a_in = colshard.grad_psum(a_int, mesh, model)
    else:
        s_w = colshard.split(s_w(colshard.whole(p["s_w"])), mesh, model, 0)
        s_p = colshard.split(s_p(colshard.whole(p["s_p"])), mesh, model, 1)
        a_in = colshard.split(a_int, mesh, model, -1)
    w_int = cl.weight_codes(w_loc, s_w, cim, t)
    deq = cl.place_values(cim.weight_bits, cim.cell_bits,
                          device=s_w.device)[:, None, None] * s_w[None]
    with obs_adc.partial_over(partial):
        y = cl.emulate_macs(a_in, w_int, s_p, deq, cim, rows=rows)
    y = (colshard.gather(y, mesh, model, -1) if d == 1
         else colshard.psum(y, mesh, model))
    return (y * torch.clamp_min(s_a, 1e-9)).to(compute_dtype)


def _cols(leaf, broadcast, mesh, dim):
    """This rank's columns of a layer scale: the local block of one placed
    with the weight's columns, else cut from the replicated scale
    broadcast to every column (``colshard.split``: the ranks' gradients
    gathered)."""
    if colshard.model_dim(leaf) is not None:
        return leaf.to_local()
    return colshard.split(broadcast(colshard.whole(leaf)), mesh, ("model",),
                          dim)
