"""The ``binary`` hardware style (counterpart of ``repro.backends.binary``):
S = 1 sign planes, multi-bit activations.

Each weight is one +-1 cell with a per-(array tile, column) real scale
alpha, the BWN mean |w| over the tile's real rows, so the bit-split axis
collapses (``plane_bits = (1, 1)``): one physical column per weight, no
shift-and-add across splits.

* Pack (``pack_linear_binary`` / ``pack_conv_binary``): ``sign(w)`` as
  one (1, k_tiles, rows, N) plane, or (1, k_tiles, kh, kw, cpa, C_out)
  for conv; padded rows and channels hold digit 0. Dense int8 storage
  (dense int4 is int8 in [-8, 7] in the port), no nibbles and no
  occupancy map, as the reference packs it. ``s_w`` is alpha + 1e-9 at
  (k_tiles, N); ``s_p`` is the analytic (1, k_tiles, N) ADC scale,
  refined on data by ``binary_calibrate_psum_scale``; ``s_a`` carries
  over, so calibrate on emulate first.
* Forward: the deploy kernels (``cim_matmul_cuda`` / ``cim_conv_cuda``)
  with S = 1 planes and ``deq = alpha``; the activation scale is applied
  after the shift-and-add, as in the port's deploy (the reference folds
  it into ``deq``: one float rounding apart). Cell variation perturbs the
  S = 1 planes as on deploy.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.api.backends import (Backend, conv_plane_tiling,
                                      plane_tiling, register_backend)
from repro_torch.core.colshard import col_apply
from repro_torch.core.cim_linear import (CIMConfig, _tile_inputs,
                                         bake_variation, deploy_act_codes)
from repro_torch.core.quantizer import qrange


def _f32(v) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32)


def _analytic_s_p(t, cfg: CIMConfig, shape, device) -> torch.Tensor:
    """|P| ~ sqrt(rows) * E|a_int| * E|digit| with 1-bit cells, evaluated in
    float32 in the reference's order of operations."""
    _, qp_p = qrange(cfg.psum_bits, True)
    p_mag = torch.sqrt(_f32(t.array_rows)) * (2 ** (cfg.act_bits - 2)) / 2.0
    s = 2.0 * p_mag / torch.sqrt(_f32(max(qp_p, 1)))
    return torch.full(tuple(shape), float(s), dtype=torch.float32,
                      device=device)


def _sign(w: torch.Tensor) -> torch.Tensor:
    return torch.where(w >= 0, 1.0, -1.0)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def pack_linear_binary(params: Dict[str, torch.Tensor], cfg: CIMConfig, *,
                       variation=None,
                       variation_std=None) -> Dict[str, torch.Tensor]:
    """Binarize trained float params {w, s_w, s_p, s_a} into the S = 1
    packed form; the multi-bit s_w and s_p are replaced. ``variation``
    bakes one device realization, as ``_pack_linear`` does."""
    w = params["w"].to(torch.float32)
    k, n = w.shape
    t = plane_tiling(cfg, k, n)
    pad_k = t.k_padded - k
    sign = F.pad(_sign(w), (0, 0, 0, pad_k))             # dead rows: digit 0
    digits = sign.reshape(t.k_tiles, t.array_rows, n)[None]
    w_t = F.pad(w.abs(), (0, 0, 0, pad_k)).reshape(t.k_tiles, t.array_rows,
                                                   n)
    rows = torch.clamp_max(
        k - torch.arange(t.k_tiles, device=w.device) * t.array_rows,
        t.array_rows).to(torch.float32)
    alpha = w_t.sum(dim=1) / rows[:, None]                # (kt, n)
    out = {
        "w_digits": digits.to(torch.int8),
        "s_w": alpha + 1e-9,
        "s_p": _analytic_s_p(t, cfg, (1, t.k_tiles, n), w.device),
        "s_a": params["s_a"],
        "k_logical": torch.tensor(k, dtype=torch.int32, device=w.device),
    }
    return bake_variation(out, variation, variation_std)


def pack_conv_binary(params: Dict[str, torch.Tensor], cfg: CIMConfig, *,
                     variation=None,
                     variation_std=None) -> Dict[str, torch.Tensor]:
    """Binarize an HWIO conv into the S = 1 stretched-kernel form (1,
    k_tiles, kh, kw, c_per_array, C_out), the deploy conv pack's layout at
    n_split = 1; alpha is the mean |w| over a slice's real channels and
    all taps."""
    w = params["w"].to(torch.float32)
    kh, kw, c_in, c_out = w.shape
    t, cpa = conv_plane_tiling(cfg, kh, kw, c_in, c_out)
    c_pad = t.k_tiles * cpa - c_in
    sign = F.pad(_sign(w), (0, 0, 0, c_pad))
    d = sign.reshape(kh, kw, t.k_tiles, cpa, c_out).permute(2, 0, 1, 3, 4)
    w_t = F.pad(w.abs(), (0, 0, 0, c_pad)).reshape(kh, kw, t.k_tiles, cpa,
                                                   c_out)
    ch = torch.clamp_max(
        c_in - torch.arange(t.k_tiles, device=w.device) * cpa,
        cpa).to(torch.float32)
    alpha = w_t.sum(dim=(0, 1, 3)) / (ch[:, None] * kh * kw)   # (kt, co)
    out = {
        "w_digits": d[None].contiguous().to(torch.int8),
        "s_w": alpha + 1e-9,
        "s_p": _analytic_s_p(t, cfg, (1, t.k_tiles, c_out), w.device),
        "s_a": params["s_a"],
    }
    return bake_variation(out, variation, variation_std)


def binary_calibrate_psum_scale(packed: Dict[str, torch.Tensor],
                                cfg: CIMConfig,
                                x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Data-driven s_p of a PACKED binary linear layer: the LSQ-style
    2 E|P| / sqrt(q_p) on the sign-plane partial sums of a calibration
    batch (float64 MACs, exact)."""
    digits = packed["w_digits"].to(torch.float64)          # (1, kt, rows, N)
    t = plane_tiling(cfg, int(x.shape[-1]), int(digits.shape[-1]))
    a_int = deploy_act_codes(x, packed["s_a"], cfg)
    a_t = _tile_inputs(a_int.to(torch.float64), t)
    flat = a_t.reshape((-1,) + tuple(a_t.shape[-2:]))
    psum = torch.einsum("mtr,strn->mstn", flat, digits)
    mean_abs = psum.abs().mean(dim=0).to(torch.float32)   # (1, kt, N)
    _, qp_p = qrange(cfg.psum_bits, True)
    s_p = 2.0 * mean_abs / torch.sqrt(_f32(max(qp_p, 1))).to(x.device)
    return {**packed, "s_p": s_p + 1e-9}


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

def _deq(params, t) -> torch.Tensor:
    """(1, kt, N): alpha at place value 2^0, times an optional gain."""
    def deq_of(s_w, gain):
        deq = s_w[None]
        return deq if gain is None else deq * gain
    return col_apply(deq_of, t.broadcast_weight_scale(params["s_w"]),
                     params.get("deq_scale"))


def _linear_binary(x, params, cfg, variation, sigma, compute_dtype):
    from repro_torch.kernels import ops as kops
    from repro_torch.nn.module import current_mesh
    digits = params["w_digits"]                           # (1, kt, rows, N)
    s_a = params["s_a"]
    t = plane_tiling(cfg, x.shape[-1], digits.shape[-1])
    if (t.k_tiles, t.array_rows) != tuple(digits.shape[1:3]):
        raise ValueError(f"packed binary planes {tuple(digits.shape)} do not "
                         f"fit K={x.shape[-1]} under tiling "
                         f"{(t.k_tiles, t.array_rows)}")
    a_t = _tile_inputs(deploy_act_codes(x, s_a, cfg), t)
    y = kops.cim_matmul(a_t, digits, t.broadcast_psum_scale(params["s_p"]),
                        _deq(params, t), psum_bits=cfg.psum_bits,
                        psum_quant=cfg.psum_quant, use_kernel=cfg.use_kernel,
                        variation=variation, variation_std=sigma,
                        mesh=current_mesh())
    y = y * torch.clamp_min(s_a, 1e-9)
    return y.to(compute_dtype)


def _conv_binary(x, params, cfg, stride, padding, variation, sigma,
                 compute_dtype):
    from repro_torch.kernels import ops as kops
    from repro_torch.nn.module import current_mesh
    d6 = params["w_digits"]                  # (1, kt, kh, kw, cpa, C_out)
    s1, k_tiles, kh, kw, cpa, c_out = d6.shape
    t, cpa2 = conv_plane_tiling(cfg, kh, kw, x.shape[-1], c_out)
    if (t.k_tiles, cpa2) != (k_tiles, cpa):
        raise ValueError(
            f"packed binary conv planes {tuple(d6.shape)} were built for a "
            f"different geometry than x/cfg imply: expected (k_tiles, "
            f"c_per_array)={(t.k_tiles, cpa2)}, packed {(k_tiles, cpa)}")
    s_a = params["s_a"]
    y = kops.cim_conv(deploy_act_codes(x, s_a, cfg),
                      col_apply(lambda d: d.reshape(s1, k_tiles, kh * kw * cpa,
                                                    d.shape[-1]), d6),
                      t.broadcast_psum_scale(params["s_p"]), _deq(params, t),
                      kh=kh, kw=kw, stride=stride, padding=padding,
                      c_per_array=cpa, psum_bits=cfg.psum_bits,
                      psum_quant=cfg.psum_quant, use_kernel=cfg.use_kernel,
                      variation=variation, variation_std=sigma,
                      mesh=current_mesh())
    y = y * torch.clamp_min(s_a, 1e-9)
    return y.to(compute_dtype)


BINARY = register_backend(Backend(
    name="binary", linear=_linear_binary, conv=_conv_binary, packed=True,
    description="binary-weight CIM: S=1 sign planes with per-column mean-|w| "
                "scales and multi-bit activations, on the deploy kernels",
    pack_linear=pack_linear_binary, pack_conv=pack_conv_binary,
    plane_bits=(1, 1)))
