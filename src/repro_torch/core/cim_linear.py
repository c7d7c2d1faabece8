"""CIM-mapped linear layer with column-wise weight and partial-sum
quantization (counterpart of ``repro.core.cim_linear``).

Backends (``CIMConfig.mode``, resolved through ``repro_torch.api.backends``):

  off      plain matmul in the compute dtype.
  emulate  LSQ fake-quant of activations and weights, bit-split digits,
           per-array integer partial sums, ADC quantization of each
           (split, array, column) partial sum, dequant, shift-and-add;
           differentiable, with the reference's LSQ and straight-through
           gradients (the path QAT trains).
  deploy   the same arithmetic from packed digit planes through the fused
           CIM matmul kernel (``kernels/ops.cim_matmul``).
  ref      deploy forced onto the plain PyTorch version of the kernel.

The hardware-style backends ``adc_free`` and ``binary`` live in
``repro_torch.backends``.

Emulate and deploy are bit-identical within the port: both accumulate
``ADC(psum) * deq_w`` in (array tile outer, split inner) order with
``deq_w = 2^(c*s) * s_w``, and apply the activation scale ``s_a`` after
the shift-and-add (``kernels.ref.shift_add``). The reference folds
``s_a`` into ``deq`` instead; the two differ by one float rounding, well
inside the 1e-4 parity gate.

Cell variation (``core.variation``): a forward takes ``variation`` (a
theta tensor or a ``Sampler``) and ``variation_std``; the noise lands on
the logical packed layout (S, k_tiles, rows, N) on both paths. Under
variation the emulate MACs run in float64, as the deploy kernel and its
plain version run them, so the two stay bit-identical. A ``DriftState``
sigma with a drift source flows the same way.

When the ``obs.adc`` collector is armed, emulate records its exact ADC
counters on the detached partial sums (QAT's autograd is untouched).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.kernels.ref import shift_add
from repro_torch.obs import adc as obs_adc

from .bitsplit import place_values, split_digits
from .colshard import col_apply
from .granularity import ArrayTiling, Granularity
from .nibble import (INT4, can_pack_nibbles, is_nibble_packed, occupancy_map,
                     pack_nibbles)
from .quantizer import lsq_fake_quant, qrange, round_ste
from .variation import (perturb_digits, perturb_packed, resolve_sigma,
                        variation_wanted)

_BUILTIN_MODES = ("off", "emulate", "deploy", "ref")
_KNOWN_MODES = set(_BUILTIN_MODES)

_PACK_DTYPES = ("int8", "int4")


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} instead "
        "(see the migration table in README.md).",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Quantization and CIM-mapping configuration (paper Table II knobs),
    validated at construction exactly as the reference's ``CIMConfig``."""

    enabled: bool = False
    mode: str = "emulate"
    weight_bits: int = 4
    cell_bits: int = 2
    act_bits: int = 8
    psum_bits: int = 4
    array_rows: int = 128
    array_cols: int = 128
    weight_granularity: Granularity = Granularity.COLUMN
    psum_granularity: Granularity = Granularity.COLUMN
    act_signed: bool = True
    psum_quant: bool = True
    variation_std: float = 0.0
    use_kernel: bool = True
    pack_dtype: str = "int8"

    def __post_init__(self):
        if self.mode not in _KNOWN_MODES:
            raise ValueError(
                f"unknown CIM mode {self.mode!r}; registered backends: "
                f"{sorted(_KNOWN_MODES)}. Custom backends must be "
                "registered via repro_torch.api.backends.register_backend "
                "before a CIMConfig can name them.")
        if self.pack_dtype not in _PACK_DTYPES:
            raise ValueError(f"unknown pack_dtype {self.pack_dtype!r}; "
                             f"valid: {_PACK_DTYPES}")
        for field in ("weight_granularity", "psum_granularity"):
            val = getattr(self, field)
            if not isinstance(val, Granularity):
                try:
                    coerced = Granularity(val)
                except ValueError:
                    raise ValueError(
                        f"unknown {field} {val!r}; valid: "
                        f"{[g.value for g in Granularity]}") from None
                object.__setattr__(self, field, coerced)
        for field in ("weight_bits", "cell_bits", "act_bits", "psum_bits",
                      "array_rows", "array_cols"):
            if int(getattr(self, field)) < 1:
                raise ValueError(f"{field} must be >= 1, got "
                                 f"{getattr(self, field)!r}")

    def tiling(self, k: int, n: int) -> ArrayTiling:
        return ArrayTiling(k=k, n=n, array_rows=self.array_rows,
                           array_cols=self.array_cols,
                           weight_bits=self.weight_bits,
                           cell_bits=self.cell_bits)

    def replace(self, **kw) -> "CIMConfig":
        fields = {f.name for f in dataclasses.fields(self)}
        unknown = sorted(set(kw) - fields)
        if unknown:
            raise TypeError(
                f"CIMConfig.replace: unknown field(s) {unknown}; "
                f"valid fields: {sorted(fields)}")
        return dataclasses.replace(self, **kw)

    def store_dtype(self):
        """Digit-plane storage: the ``"int4"`` marker when requested and the
        sign-magnitude digits fit [-7, 7] (cells of <= 3 bits), else
        ``torch.int8``."""
        return INT4 if (self.pack_dtype == "int4"
                        and self.cell_bits <= 3) else torch.int8


# ---------------------------------------------------------------------------
# parameter initialization
# ---------------------------------------------------------------------------

def _init_linear(gen: torch.Generator, k: int, n: int, cfg: CIMConfig,
                 w_init_scale: float | None = None, *,
                 device=None) -> Dict[str, torch.Tensor]:
    """{w, s_w, s_p, s_a} for a (k, n) CIM linear layer on ``device``
    (``cuda`` unless ``"cpu"``); the weight is drawn from ``gen`` on the
    CPU, then moved."""
    device = resolve_device(device)
    std = w_init_scale if w_init_scale is not None else 1.0 / math.sqrt(k)
    w = (torch.randn((k, n), generator=gen, dtype=torch.float32) * std
         ).to(device)
    params: Dict[str, torch.Tensor] = {"w": w}
    if cfg.enabled:
        t = cfg.tiling(k, n)
        params["s_w"] = weight_scales_from(w, cfg)
        _, qp_p = qrange(cfg.psum_bits, True)
        p_mag = (math.sqrt(float(t.array_rows)) * (2 ** (cfg.act_bits - 2))
                 * (2 ** (cfg.cell_bits - 1)) / 2.0)
        params["s_p"] = torch.full(
            t.psum_scale_shape(cfg.psum_granularity),
            2.0 * p_mag / math.sqrt(float(max(qp_p, 1))),
            dtype=torch.float32, device=device)
        params["s_a"] = torch.ones((1,), dtype=torch.float32, device=device)
    return params


def weight_scales_from(w: torch.Tensor, cfg: CIMConfig) -> torch.Tensor:
    """Per-group LSQ scale init, s = 2 E|w|_group / sqrt(q_p); a column
    group is one array column's weights."""
    k, n = w.shape
    t = cfg.tiling(k, n)
    _, qp = qrange(cfg.weight_bits, True)
    w_abs = torch.abs(torch.nn.functional.pad(w, (0, 0, 0, t.k_padded - k)))
    w_t = w_abs.reshape(t.k_tiles, t.array_rows, n)
    rows = torch.clamp_max(
        k - torch.arange(t.k_tiles, device=w.device) * t.array_rows,
        t.array_rows).to(torch.float32)
    m_col = w_t.sum(dim=1) / rows[:, None]
    return _group_scale(m_col, cfg.weight_granularity, t, qp)


def _group_scale(m_col: torch.Tensor, g: Granularity, t: ArrayTiling,
                 qp: int) -> torch.Tensor:
    """Reduce per-(tile, column) mean magnitudes to the granularity's scale
    parameter: 2 * mean / sqrt(q_p) + 1e-9."""
    if g == Granularity.COLUMN:
        s = m_col
    elif g == Granularity.ARRAY:
        pad_n = t.n_tiles * t.oc_per_array - m_col.shape[-1]
        mc = torch.nn.functional.pad(m_col, (0, pad_n))
        s = mc.reshape(t.k_tiles, t.n_tiles, t.oc_per_array).mean(-1)
    else:
        s = torch.mean(m_col).reshape(1, 1)
    return (2.0 * s / math.sqrt(float(max(qp, 1)))).to(torch.float32) + 1e-9


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

def _full_weight_scale(params, t: ArrayTiling) -> torch.Tensor:
    """(k_tiles, N) weight scale of a layer's ``s_w`` parameter."""
    return t.broadcast_weight_scale(params["s_w"])


def _full_psum_scale(params, t: ArrayTiling) -> torch.Tensor:
    """(n_split, k_tiles, N) psum scale of a layer's ``s_p`` parameter."""
    return t.broadcast_psum_scale(params["s_p"])


def _quantize_weight_int(params, cfg: CIMConfig, t: ArrayTiling) -> torch.Tensor:
    """Integer weight codes (K, N) in float32, LSQ gradients attached."""
    return weight_codes(params["w"], _full_weight_scale(params, t), cfg, t)


def weight_codes(w: torch.Tensor, s_w: torch.Tensor, cfg: CIMConfig,
                 t: ArrayTiling) -> torch.Tensor:
    """Integer codes of a weight block ``w`` (K', N') under its (K'/rows,
    N') weight scales ``s_w``, LSQ gradients attached; ``t`` is the whole
    layer's tiling, whose group size sets LSQ's g (a rank's block of a
    placed weight keeps the whole layer's)."""
    w = w.to(torch.float32)
    s_full = torch.repeat_interleave(s_w, t.array_rows, dim=0)[: w.shape[0]]
    w_hat = lsq_fake_quant(
        w, s_full, cfg.weight_bits, signed=True,
        group_size=t.weight_group_size(cfg.weight_granularity))
    return w_hat / torch.clamp_min(s_full, 1e-9)


def _quantize_act(x, params, cfg: CIMConfig, rows: int = 1):
    """(a_int, s_a): integer activation codes (float32) and their scale.

    The reference divides the fake-quantized activation by s_a, which can
    land an ulp off the integer; with ``psum_quant`` off that ulp would
    reach the output, and the port's emulate would no longer equal its
    ADC-free deploy bit for bit. So the quotient is snapped to the
    integer it stands for with a straight-through step: the value is
    exactly the code ``deploy_act_codes`` gives, and the gradient is
    ``lsq_fake_quant``'s own. ``rows`` is the ranks over which a data
    parallel step splits the batch: LSQ's g counts the global batch, as
    the reference's one program does."""
    s_a = params["s_a"]
    xf = x.to(torch.float32)
    a_hat = lsq_fake_quant(xf, s_a, cfg.act_bits, signed=cfg.act_signed,
                           group_size=rows * max(
                               1, xf.numel() // max(1, s_a.numel())))
    a = a_hat / torch.clamp_min(s_a, 1e-9)
    return round_ste(a), s_a


def deploy_act_codes(x, s_a, cfg: CIMConfig) -> torch.Tensor:
    """Integer activation codes for the packed paths, narrowed to int8
    (or uint8 for unsigned 8-bit codes), as the reference narrows them."""
    qn_a, qp_a = qrange(cfg.act_bits, cfg.act_signed)
    a_int = torch.clamp(
        torch.round(x.to(torch.float32) / torch.clamp_min(s_a, 1e-9)),
        qn_a, qp_a)
    if qn_a >= -128 and qp_a <= 127:
        a_int = a_int.to(torch.int8)
    elif qn_a >= 0 and qp_a <= 255:
        a_int = a_int.to(torch.uint8)
    return a_int


def _tile_inputs(a_int: torch.Tensor, t: ArrayTiling) -> torch.Tensor:
    """(..., K) -> (..., k_tiles, rows) with zero padding."""
    pad = t.k_padded - a_int.shape[-1]
    if pad:
        a_int = torch.nn.functional.pad(a_int, (0, pad))
    return a_int.reshape(tuple(a_int.shape[:-1]) + (t.k_tiles, t.array_rows))


def _tile_digits(digits: torch.Tensor, t: ArrayTiling) -> torch.Tensor:
    """(S, K, N) -> (S, k_tiles, rows, N) with zero padding."""
    pad = t.k_padded - digits.shape[1]
    if pad:
        digits = torch.nn.functional.pad(digits, (0, 0, 0, pad))
    return digits.reshape(t.n_split, t.k_tiles, t.array_rows, t.n)


def _deq_w(params, cfg: CIMConfig, t: ArrayTiling) -> torch.Tensor:
    """(S, kt, N) dequant scales without the activation scale:
    2^(c*s) * s_w, times the optional recalibration gain ``deq_scale``."""
    s_w = _full_weight_scale(params, t)
    places = place_values(cfg.weight_bits, cfg.cell_bits, device=s_w.device)

    def deq_of(s_w, gain):
        deq = places[:, None, None] * s_w[None]
        return deq if gain is None else deq * gain
    # column-sharded leaves: computed on this rank's columns
    return col_apply(deq_of, s_w, params.get("deq_scale"))


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _linear_forward(x, params, cfg: CIMConfig, *, variation=None,
                    variation_std=None,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) through ``cfg.mode``'s backend.

    ``variation`` (theta tensor or ``Sampler``) evaluates one cell-noise
    realization at sigma ``variation_std``, else ``cfg.variation_std``."""
    if not cfg.enabled:
        return _forward_off(x, params, cfg, None, None, compute_dtype)
    from repro_torch.api.backends import get_backend  # api builds on core
    sigma = resolve_sigma(variation_std, cfg.variation_std)
    return get_backend(cfg.mode).linear(x, params, cfg, variation, sigma,
                                        compute_dtype)


def _forward_off(x, params, cfg, variation, sigma, compute_dtype):
    return x.to(compute_dtype) @ params["w"].to(compute_dtype)


def _forward_emulate(x, params, cfg, variation, sigma, compute_dtype, *,
                     rows: int = 1):
    k, n = params["w"].shape
    t = cfg.tiling(k, n)
    a_int, s_a = _quantize_act(x, params, cfg, rows)
    w_int = _quantize_weight_int(params, cfg, t)
    y = emulate_macs(a_int, w_int, _full_psum_scale(params, t),
                     _deq_w(params, cfg, t), cfg, variation, sigma, rows)
    y = y * torch.clamp_min(s_a, 1e-9)
    return y.to(compute_dtype)


def emulate_macs(a_int, w_int, s_p, deq, cfg: CIMConfig, variation=None,
                 sigma=None, rows: int = 1) -> torch.Tensor:
    """Emulate's array arithmetic on codes (..., K') and (K', N') of whole
    array tiles (or of the layer): bit-split digits, per-(split, tile,
    column) partial sums, the ADC's LSQ quantization under ``s_p`` (S, kt',
    N'), and the shift-and-add under ``deq`` (S, kt', N'), float32 (...,
    N'). ``rows`` scales LSQ's row count to the global batch (a data
    parallel step)."""
    t = cfg.tiling(w_int.shape[0], w_int.shape[1])
    digits = split_digits(w_int, cfg.weight_bits, cfg.cell_bits)
    a_t = _tile_inputs(a_int, t)
    d_t = _tile_digits(digits, t)
    if variation_wanted(variation, sigma):
        # noisy planes: float64 MACs, as the deploy kernel runs them
        d_t = perturb_digits(d_t, variation, sigma)
        psum = torch.einsum("...tr,strn->...stn", a_t.to(torch.float64),
                            d_t.to(torch.float64)).to(torch.float32)
    else:
        # integer column MACs, exact in float32 for these code widths
        psum = torch.einsum("...tr,strn->...stn", a_t, d_t)
    if cfg.psum_quant:
        # snap float roundoff to the integer grid, straight through
        psum = round_ste(psum)
        if obs_adc.enabled() and obs_adc.will_fold():
            # exact counters on the detached partial sums
            obs_adc.record(psum, s_p, cfg.psum_bits)
        psum = lsq_fake_quant(psum, s_p, cfg.psum_bits, signed=True,
                              group_size=rows * max(
                                  1, psum.numel() // max(1, s_p.numel())))
    return shift_add(psum, deq)


def _forward_deploy(x, params, cfg, variation, sigma, compute_dtype,
                    adc_free: bool = False):
    """Inference from packed digit planes (``_pack_linear``) through
    ``kernels.ops.cim_matmul``, which perturbs the planes under variation
    and, under a session mesh, runs column-parallel. ``adc_free=True``
    runs the same planes on the ADC-free kernel (the ``adc_free``
    backend)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.nn.module import current_mesh
    digits = params["w_digits"]
    s_a = params["s_a"]
    a_int = deploy_act_codes(x, s_a, cfg)
    t = cfg.tiling(x.shape[-1], digits.shape[-1])
    rows_stored = (t.array_rows // 2 if is_nibble_packed(digits)
                   else t.array_rows)
    if (t.k_tiles, rows_stored) != tuple(digits.shape[1:3]):
        raise ValueError(f"packed planes {tuple(digits.shape)} do not fit "
                         f"K={x.shape[-1]} under tiling "
                         f"{(t.k_tiles, t.array_rows)}")
    a_t = _tile_inputs(a_int, t)
    s_p = _full_psum_scale(params, t)
    y = kops.cim_matmul(a_t, digits, s_p, _deq_w(params, cfg, t),
                        psum_bits=cfg.psum_bits, psum_quant=cfg.psum_quant,
                        use_kernel=cfg.use_kernel, occ=params.get("w_occ"),
                        variation=variation, variation_std=sigma,
                        adc_free=adc_free, mesh=current_mesh())
    y = y * torch.clamp_min(s_a, 1e-9)
    return y.to(compute_dtype)


# ---------------------------------------------------------------------------
# packing + calibration
# ---------------------------------------------------------------------------

def _pack_linear(params: Dict[str, torch.Tensor], cfg: CIMConfig, *,
                 variation=None,
                 variation_std=None) -> Dict[str, torch.Tensor]:
    """Trained emulate params -> packed deploy form: (S, kt, rows, N) digit
    planes (int8, or nibble uint8 for int4 with even rows), the ``w_occ``
    occupancy map, the scales and ``k_logical``. Byte-identical with the
    reference's ``_pack_linear``.

    ``variation`` with a sigma (``variation_std``) bakes
    ONE device realization into float32 planes (``perturb_packed``); for
    Monte-Carlo sweeps keep the planes clean and pass ``variation`` to the
    forward instead."""
    k, n = params["w"].shape
    t = cfg.tiling(k, n)
    w_int = _quantize_weight_int(params, cfg, t)
    digits = split_digits(w_int, cfg.weight_bits, cfg.cell_bits)
    d_t = _tile_digits(digits, t).to(torch.int8)
    occ = occupancy_map(d_t)
    if can_pack_nibbles(t.array_rows, cfg.store_dtype()):
        d_t = pack_nibbles(d_t)
    out = {
        "w_digits": d_t,
        "w_occ": occ,
        "s_w": params["s_w"],
        "s_p": params["s_p"],
        "s_a": params["s_a"],
        "k_logical": torch.tensor(k, dtype=torch.int32,
                                  device=params["w"].device),
    }
    return bake_variation(out, variation, variation_std)


def bake_variation(packed, variation, variation_std):
    """``perturb_packed`` when a realization is asked for at pack time."""
    if variation_wanted(variation, variation_std):
        return perturb_packed(packed, variation, variation_std)
    return packed


def _calibrate_linear(x, params, cfg: CIMConfig) -> Dict[str, torch.Tensor]:
    """One-batch calibration of s_a and s_p (LSQ-style init from stats)."""
    if not cfg.enabled:
        return params
    k, n = params["w"].shape
    t = cfg.tiling(k, n)
    p = dict(params)
    _, qp_a = qrange(cfg.act_bits, cfg.act_signed)
    p["s_a"] = (2.0 * torch.mean(torch.abs(x.to(torch.float32)))
                / math.sqrt(float(max(qp_a, 1)))).reshape(1) + 1e-9
    a_int, _ = _quantize_act(x, p, cfg)
    w_int = _quantize_weight_int(p, cfg, t)
    digits = split_digits(w_int, cfg.weight_bits, cfg.cell_bits)
    psum = torch.einsum("...tr,strn->...stn", _tile_inputs(a_int, t),
                        _tile_digits(digits, t))
    mean_abs = torch.mean(torch.abs(psum.reshape((-1,) + psum.shape[-3:])),
                          dim=0)
    p["s_p"] = _psum_scale(mean_abs, cfg, t)
    return p


def _psum_scale(mean_abs: torch.Tensor, cfg: CIMConfig,
                t: ArrayTiling) -> torch.Tensor:
    """(S, kt, N) mean |psum| -> the psum-granularity scale parameter."""
    _, qp_p = qrange(cfg.psum_bits, True)
    pg = cfg.psum_granularity
    if pg == Granularity.LAYER:
        s = torch.mean(mean_abs, dim=(1, 2), keepdim=True)
    elif pg == Granularity.ARRAY:
        pad_n = t.n_tiles * t.oc_per_array - t.n
        ma = torch.nn.functional.pad(mean_abs, (0, pad_n))
        s = torch.mean(ma.reshape(t.n_split, t.k_tiles, t.n_tiles,
                                  t.oc_per_array), dim=-1)
    else:
        s = mean_abs
    return (2.0 * s / math.sqrt(float(max(qp_p, 1)))).to(torch.float32) + 1e-9


# ---------------------------------------------------------------------------
# deprecated entry points (the reference's pre-``api`` surface)
# ---------------------------------------------------------------------------

def init_cim_linear(*args, **kw) -> Dict[str, torch.Tensor]:
    """Deprecated: use ``repro_torch.api.init_linear``."""
    _deprecated("init_cim_linear", "repro_torch.api.init_linear")
    return _init_linear(*args, **kw)


def cim_linear(*args, **kw) -> torch.Tensor:
    """Deprecated: use ``repro_torch.api.linear``."""
    _deprecated("cim_linear", "repro_torch.api.linear")
    return _linear_forward(*args, **kw)


def calibrate_cim(*args, **kw) -> Dict[str, torch.Tensor]:
    """Deprecated: use ``repro_torch.api.calibrate_linear``."""
    _deprecated("calibrate_cim", "repro_torch.api.calibrate_linear")
    return _calibrate_linear(*args, **kw)


def pack_deploy(*args, **kw) -> Dict[str, torch.Tensor]:
    """Deprecated: use ``repro_torch.api.pack_linear`` or
    ``QuantLinear.pack`` (a saveable ``DeployArtifact``)."""
    _deprecated("pack_deploy", "repro_torch.api.pack_linear")
    return _pack_linear(*args, **kw)
