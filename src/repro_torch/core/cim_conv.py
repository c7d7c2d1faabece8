"""CIM-oriented convolution (paper §III-C), counterpart of
``repro.core.cim_conv``.

Stretched-kernel tiling: each array holds ``c_per_array = floor(rows /
(kh*kw))`` whole input channels with all their taps. ``emulate`` runs all
(split, array tile) channel-slice convolutions as ONE grouped convolution
(``groups = n_split * k_tiles``) whose output channels are the per-array
partial sums; ``deploy`` runs the packed digit planes through the fused
conv kernel (``kernels/ops.cim_conv``).

Layouts stay NHWC / HWIO at every function boundary, as in the reference,
so packed planes are byte-identical with the JAX pack; tensors go to NCHW
only around ``F.conv2d``. As in ``core.cim_linear``, emulate and deploy
apply the activation scale after the shift-and-add and are bit-identical
within the port, with cell variation too: the noise is drawn over the 6-D
packed layout (S, k_tiles, kh, kw, c_per_array, C_out) on both paths, and
under variation the emulate grouped conv runs in float64, as the deploy
kernel runs its MACs. A ``DriftState`` sigma with a drift source flows the
same way. When the ``obs.adc`` collector is armed, emulate records its
exact ADC counters on the detached partial sums.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels.ref import conv_pads, shift_add
from repro_torch.obs import adc as obs_adc

from .bitsplit import split_digits
from .colshard import col_apply
from .cim_linear import (CIMConfig, _deprecated, _deq_w, _group_scale,
                         _psum_scale, _quantize_act, bake_variation,
                         deploy_act_codes)
from .granularity import conv_tiling
from .nibble import (can_pack_nibbles, is_nibble_packed, occupancy_map,
                     pack_nibbles)
from .quantizer import lsq_fake_quant, qrange, round_ste
from .variation import resolve_sigma, variation_noise, variation_wanted


def _init_conv(gen: torch.Generator, kh: int, kw: int, c_in: int, c_out: int,
               cfg: CIMConfig, *, device=None) -> Dict[str, torch.Tensor]:
    """Params of a CIM conv layer on ``device`` (``cuda`` unless
    ``"cpu"``), weight HWIO drawn from ``gen`` on the CPU (He init), then
    moved."""
    device = resolve_device(device)
    fan_in = kh * kw * c_in
    w = (torch.randn((kh, kw, c_in, c_out), generator=gen,
                     dtype=torch.float32) * math.sqrt(2.0 / fan_in)).to(device)
    params: Dict[str, torch.Tensor] = {"w": w}
    if cfg.enabled:
        t, _ = conv_tiling(kh, kw, c_in, c_out, cfg.array_rows,
                           cfg.array_cols, cfg.weight_bits, cfg.cell_bits)
        params["s_w"] = conv_weight_scales_from(w, cfg)
        _, qp_p = qrange(cfg.psum_bits, True)
        p_mag = (math.sqrt(float(t.array_rows)) * (2 ** (cfg.act_bits - 2))
                 * (2 ** (cfg.cell_bits - 1)) / 2.0)
        params["s_p"] = torch.full(
            t.psum_scale_shape(cfg.psum_granularity),
            2.0 * p_mag / math.sqrt(float(max(qp_p, 1))),
            dtype=torch.float32, device=device)
        params["s_a"] = torch.ones((1,), dtype=torch.float32, device=device)
    return params


def conv_weight_scales_from(w: torch.Tensor, cfg: CIMConfig) -> torch.Tensor:
    """Per-group LSQ init for conv weights: a column group is one output
    channel's taps within one channel-slice array."""
    kh, kw, c_in, c_out = w.shape
    t, cpa = conv_tiling(kh, kw, c_in, c_out, cfg.array_rows, cfg.array_cols,
                         cfg.weight_bits, cfg.cell_bits)
    _, qp = qrange(cfg.weight_bits, True)
    pad_c = t.k_tiles * cpa - c_in
    w_abs = torch.abs(F.pad(w.to(torch.float32), (0, 0, 0, pad_c)))
    w_t = w_abs.reshape(kh * kw, t.k_tiles, cpa, c_out)
    ch = torch.clamp_max(
        c_in - torch.arange(t.k_tiles, device=w.device) * cpa,
        cpa).to(torch.float32)
    m_col = w_t.sum(dim=(0, 2)) / (ch[:, None] * kh * kw)
    return _group_scale(m_col, cfg.weight_granularity, t, qp)


def _quantize_conv_weight_int(params, cfg: CIMConfig, t, c_per_array, kh, kw,
                              c_in, c_out) -> torch.Tensor:
    """Integer codes (kh, kw, c_in, c_out) with per-(array, column) scales,
    LSQ gradients attached."""
    w = params["w"].to(torch.float32)
    s_w = t.broadcast_weight_scale(params["s_w"])            # (kt, C_out)
    tile_of_c = torch.arange(c_in, device=w.device) // c_per_array
    s_full = torch.broadcast_to(s_w[tile_of_c][None, None],
                                (kh, kw, c_in, c_out))
    w_hat = lsq_fake_quant(
        w, s_full, cfg.weight_bits, signed=True,
        group_size=t.weight_group_size(cfg.weight_granularity))
    return w_hat / torch.clamp_min(s_full, 1e-9)


def _grouped_conv_psum(a_int: torch.Tensor, digits: torch.Tensor, k_tiles: int,
                       c_per_array: int, stride: int, padding,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """Per-(split, array tile) partial sums of every output position, as one
    grouped conv: (B, H, W, C_in) codes and (S, kh, kw, C_in, C_out) digits
    -> (B, H', W', S, k_tiles, C_out) float32. ``noise``, a cell-variation
    factor over the packed (S, k_tiles, kh, kw, cpa, C_out) layout,
    multiplies the digits; the conv then runs in float64."""
    n_split, kh, kw, c_in, c_out = digits.shape
    b, h, w, _ = a_int.shape
    c_pad = k_tiles * c_per_array - c_in
    mac = torch.float32 if noise is None else torch.float64
    a_p = F.pad(a_int.to(torch.float32), (0, c_pad)).to(mac)
    d_p = F.pad(digits.to(torch.float32), (0, 0, 0, c_pad))
    d_p = d_p.reshape(n_split, kh, kw, k_tiles, c_per_array, c_out)
    if noise is not None:
        d_p = d_p * noise.permute(0, 2, 3, 1, 4, 5)
    # group g = s * k_tiles + t; output channel g * C_out + c
    d_g = (d_p.to(mac).permute(0, 3, 5, 4, 1, 2)
           .reshape(n_split * k_tiles * c_out, c_per_array, kh, kw))
    # activations: the channel slices once per split, NCHW for F.conv2d
    a_g = a_p.repeat(1, 1, 1, n_split).permute(0, 3, 1, 2)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = conv_pads(h, w, kh, kw, stride, padding)
    a_g = F.pad(a_g, (pw_lo, pw_hi, ph_lo, ph_hi))
    psum = F.conv2d(a_g, d_g, stride=stride,
                    groups=n_split * k_tiles).to(torch.float32)
    ho, wo = psum.shape[2:]
    return psum.permute(0, 2, 3, 1).reshape(b, ho, wo, n_split, k_tiles, c_out)


def _conv_forward(x, params, cfg: CIMConfig, *, stride: int = 1,
                  padding="SAME", variation=None, variation_std=None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Conv2d through the CIM framework: (B, H, W, C_in) NHWC ->
    (B, H', W', C_out), through ``cfg.mode``'s backend. ``variation``
    (theta tensor over the 6-D packed layout, or a ``Sampler``) evaluates
    one cell-noise realization, as in ``core.cim_linear``."""
    if not cfg.enabled:
        return _forward_conv_off(x, params, cfg, stride, padding, None, None,
                                 compute_dtype)
    from repro_torch.api.backends import get_backend  # api builds on core
    sigma = resolve_sigma(variation_std, cfg.variation_std)
    return get_backend(cfg.mode).conv(x, params, cfg, stride, padding,
                                      variation, sigma, compute_dtype)


def _forward_conv_off(x, params, cfg, stride, padding, variation, sigma,
                      compute_dtype):
    kh, kw = params["w"].shape[:2]
    h, w = x.shape[1:3]
    (ph_lo, ph_hi), (pw_lo, pw_hi) = conv_pads(h, w, kh, kw, stride, padding)
    xn = F.pad(x.to(compute_dtype).permute(0, 3, 1, 2),
               (pw_lo, pw_hi, ph_lo, ph_hi))
    y = F.conv2d(xn, params["w"].to(compute_dtype).permute(3, 2, 0, 1),
                 stride=stride)
    return y.permute(0, 2, 3, 1)


def _forward_conv_emulate(x, params, cfg, stride, padding, variation, sigma,
                          compute_dtype):
    kh, kw, c_in, c_out = params["w"].shape
    t, cpa = conv_tiling(kh, kw, c_in, c_out, cfg.array_rows, cfg.array_cols,
                         cfg.weight_bits, cfg.cell_bits)
    a_int, s_a = _quantize_act(x, params, cfg)
    w_int = _quantize_conv_weight_int(params, cfg, t, cpa, kh, kw, c_in, c_out)
    digits = split_digits(w_int, cfg.weight_bits, cfg.cell_bits)
    noise = None
    if variation_wanted(variation, sigma):
        noise = variation_noise(
            variation, (t.n_split, t.k_tiles, kh, kw, cpa, c_out), sigma,
            device=digits.device)
    psum = _grouped_conv_psum(a_int, digits, t.k_tiles, cpa, stride, padding,
                              noise)
    if cfg.psum_quant or noise is None:
        # the integer snap, the ADC's first step, straight through. On
        # clean planes the MACs are integer-valued and it only removes the
        # conv algorithm's float roundoff (cuDNN may pick Winograd or FFT),
        # so emulate stays bit-exact with the ADC-free kernel when the ADC
        # is off; its gradient is the identity, as the reference's
        psum = round_ste(psum)
    if cfg.psum_quant:
        s_p = t.broadcast_psum_scale(params["s_p"])
        if obs_adc.enabled() and obs_adc.will_fold():
            # exact counters on the detached partial sums
            obs_adc.record(psum, s_p, cfg.psum_bits)
        psum = lsq_fake_quant(psum, s_p, cfg.psum_bits, signed=True)
    y = shift_add(psum, _deq_w(params, cfg, t))
    y = y * torch.clamp_min(s_a, 1e-9)
    return y.to(compute_dtype)


def conv_deploy_operands(x, params, cfg: CIMConfig) -> Dict:
    """The fused conv kernel's operands for packed 6-D conv planes
    (``_pack_conv``), whose shape carries the conv geometry: activation
    codes ``a_int`` (B, H, W, C_in), flattened ``digits`` (S, kt,
    kh*kw*cpa_stored, C_out), ``s_p`` and ``deq`` (S, kt, C_out), ``occ``,
    and ``kh``, ``kw``, ``c_per_array``. ``deq`` leaves out the activation
    scale, which the forward applies after the shift-and-add. The planes
    come clean: cell variation is applied at dispatch
    (``kernels/ops.cim_conv``)."""
    d6 = params["w_digits"]              # (S, kt, kh, kw, cpa, C_out)
    n_split, k_tiles, kh, kw, cpa_stored, c_out = d6.shape
    c_per_array = 2 * cpa_stored if is_nibble_packed(d6) else cpa_stored
    digits = col_apply(lambda d: d.reshape(n_split, k_tiles,
                                           kh * kw * cpa_stored, d.shape[-1]),
                       d6)
    t, cpa = conv_tiling(kh, kw, x.shape[-1], c_out, cfg.array_rows,
                         cfg.array_cols, cfg.weight_bits, cfg.cell_bits)
    if (t.k_tiles, cpa) != (k_tiles, c_per_array):
        raise ValueError(
            f"packed digit planes {tuple(d6.shape)} were built for a "
            f"different geometry than x/cfg imply: expected (k_tiles, "
            f"c_per_array)={(t.k_tiles, cpa)}, packed "
            f"{(k_tiles, c_per_array)}")
    return {"a_int": deploy_act_codes(x, params["s_a"], cfg),
            "digits": digits, "s_p": t.broadcast_psum_scale(params["s_p"]),
            "deq": _deq_w(params, cfg, t), "occ": params.get("w_occ"),
            "kh": kh, "kw": kw, "c_per_array": c_per_array}


def _forward_conv_deploy(x, params, cfg: CIMConfig, stride, padding,
                         variation, sigma, compute_dtype,
                         adc_free: bool = False):
    """Inference from packed 6-D conv planes through the fused conv kernel
    (``kernels/ops.cim_conv``), which perturbs the planes under variation.
    ``adc_free=True`` runs the same planes on the ADC-free conv kernel."""
    from repro_torch.kernels import ops as kops
    from repro_torch.nn.module import current_mesh
    op = conv_deploy_operands(x, params, cfg)
    y = kops.cim_conv(op["a_int"], op["digits"], op["s_p"], op["deq"],
                      kh=op["kh"], kw=op["kw"], stride=stride,
                      padding=padding, c_per_array=op["c_per_array"],
                      psum_bits=cfg.psum_bits, psum_quant=cfg.psum_quant,
                      use_kernel=cfg.use_kernel, occ=op["occ"],
                      variation=variation, variation_std=sigma,
                      adc_free=adc_free, mesh=current_mesh())
    y = y * torch.clamp_min(params["s_a"], 1e-9)
    return y.to(compute_dtype)


def _pack_conv(params: Dict[str, torch.Tensor], cfg: CIMConfig, *,
               variation=None,
               variation_std=None) -> Dict[str, torch.Tensor]:
    """Trained emulate conv params -> packed deploy form: 6-D (S, k_tiles,
    kh, kw, c_per_array, C_out) int8 planes (row order (dh, dw, c) as
    ``extract_conv_patches``), nibble-packed on the cpa axis for int4 with
    even c_per_array, plus the ``w_occ`` map. Byte-identical with the
    reference's ``_pack_conv``. ``variation`` bakes one device
    realization into float32 6-D planes, as ``_pack_linear`` does."""
    kh, kw, c_in, c_out = params["w"].shape
    t, cpa = conv_tiling(kh, kw, c_in, c_out, cfg.array_rows, cfg.array_cols,
                         cfg.weight_bits, cfg.cell_bits)
    w_int = _quantize_conv_weight_int(params, cfg, t, cpa, kh, kw, c_in, c_out)
    digits = split_digits(w_int, cfg.weight_bits, cfg.cell_bits)
    n_split = digits.shape[0]
    d = F.pad(digits, (0, 0, 0, t.k_tiles * cpa - c_in))
    d = d.reshape(n_split, kh, kw, t.k_tiles, cpa, c_out)
    d = d.permute(0, 3, 1, 2, 4, 5).contiguous().to(torch.int8)
    occ = occupancy_map(d, conv=True)
    if can_pack_nibbles(cpa, cfg.store_dtype()):
        d = pack_nibbles(d)
    return bake_variation({"w_digits": d, "w_occ": occ, "s_w": params["s_w"],
                           "s_p": params["s_p"], "s_a": params["s_a"]},
                          variation, variation_std)


def _calibrate_conv(x, params, cfg: CIMConfig, *, stride: int = 1,
                    padding="SAME") -> Dict[str, torch.Tensor]:
    """One-batch LSQ-style calibration of s_a and s_p for a conv layer."""
    if not cfg.enabled:
        return params
    kh, kw, c_in, c_out = params["w"].shape
    t, cpa = conv_tiling(kh, kw, c_in, c_out, cfg.array_rows, cfg.array_cols,
                         cfg.weight_bits, cfg.cell_bits)
    p = dict(params)
    _, qp_a = qrange(cfg.act_bits, cfg.act_signed)
    p["s_a"] = (2.0 * torch.mean(torch.abs(x.to(torch.float32)))
                / math.sqrt(float(max(qp_a, 1)))).reshape(1) + 1e-9
    a_int, _ = _quantize_act(x, p, cfg)
    w_int = _quantize_conv_weight_int(p, cfg, t, cpa, kh, kw, c_in, c_out)
    digits = split_digits(w_int, cfg.weight_bits, cfg.cell_bits)
    psum = _grouped_conv_psum(a_int, digits, t.k_tiles, cpa, stride, padding)
    mean_abs = torch.mean(torch.abs(psum.reshape((-1,) + psum.shape[-3:])),
                          dim=0)
    p["s_p"] = _psum_scale(mean_abs, cfg, t)
    return p


def conv_dequant_muls(params, cfg: CIMConfig) -> int:
    """Paper Fig. 8 x-axis: dequant scale multiplications for this layer."""
    kh, kw, c_in, c_out = params["w"].shape
    t, _ = conv_tiling(kh, kw, c_in, c_out, cfg.array_rows, cfg.array_cols,
                       cfg.weight_bits, cfg.cell_bits)
    return t.dequant_muls(cfg.weight_granularity, cfg.psum_granularity)


# ---------------------------------------------------------------------------
# deprecated entry points (the reference's pre-``api`` surface)
# ---------------------------------------------------------------------------

def init_cim_conv(*args, **kw) -> Dict[str, torch.Tensor]:
    """Deprecated: use ``repro_torch.api.init_conv``."""
    _deprecated("init_cim_conv", "repro_torch.api.init_conv")
    return _init_conv(*args, **kw)


def cim_conv2d(*args, **kw) -> torch.Tensor:
    """Deprecated: use ``repro_torch.api.conv2d``."""
    _deprecated("cim_conv2d", "repro_torch.api.conv2d")
    return _conv_forward(*args, **kw)


def calibrate_cim_conv(*args, **kw) -> Dict[str, torch.Tensor]:
    """Deprecated: use ``repro_torch.api.calibrate_conv``."""
    _deprecated("calibrate_cim_conv", "repro_torch.api.calibrate_conv")
    return _calibrate_conv(*args, **kw)


def pack_deploy_conv(*args, **kw) -> Dict[str, torch.Tensor]:
    """Deprecated: use ``repro_torch.api.pack_conv`` or
    ``QuantConv2d.pack`` (a saveable ``DeployArtifact``)."""
    _deprecated("pack_deploy_conv", "repro_torch.api.pack_conv")
    return _pack_conv(*args, **kw)
