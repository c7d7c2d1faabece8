"""Plain PyTorch versions of the CIM kernels (counterpart of
``repro.kernels.ref``).

They define the arithmetic the CUDA kernels in ``csrc/cim_matmul.cu``
must reproduce (with the ADC, ADC-free, and batched over MoE experts),
run on the CPU and on the card, and are what the wrappers use for CPU
tensors. The shift-and-add accumulates in the kernel's order (array tile
outer, split inner, one rounded multiply and one rounded add per term),
so the kernel and this version agree bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def adc_quantize_ref(p: torch.Tensor, s_p: torch.Tensor,
                     psum_bits: int) -> torch.Tensor:
    """ADC model: uniform quantization of an (integer-valued) partial sum
    at scale s_p, clipped to the signed psum_bits range; psum_bits == 1
    is the sign ADC (psum 0 -> +s_p)."""
    p = torch.round(p)
    s_p = torch.clamp_min(s_p, 1e-9)
    if psum_bits == 1:
        return torch.where(p >= 0, 1.0, -1.0).to(p.dtype) * s_p
    qn = -(2 ** (psum_bits - 1))
    qp = 2 ** (psum_bits - 1) - 1
    return torch.clamp(torch.round(p / s_p), qn, qp) * s_p


def shift_add(psum: torch.Tensor, deq: torch.Tensor) -> torch.Tensor:
    """Fused dequant and shift-and-add: (..., S, kt, N) quantized partial
    sums times (S, kt, N) scales, summed in the kernel's order (tile t
    outer, split s inner) into a float32 (..., N) output."""
    n_split, k_tiles, n = deq.shape
    out = torch.zeros(tuple(psum.shape[:-3]) + (n,), dtype=torch.float32,
                      device=psum.device)
    for t in range(k_tiles):
        for s in range(n_split):
            out = out + psum[..., s, t, :] * deq[s, t]
    return out


def cim_matmul_ref(a_t: torch.Tensor, digits: torch.Tensor,
                   s_p: torch.Tensor, deq: torch.Tensor, *, psum_bits: int,
                   psum_quant: bool = True) -> torch.Tensor:
    """CIM matmul: per-(split, array) integer MACs, ADC quantization of each
    column partial sum, fused dequant, shift-and-add.

    a_t (M, k_tiles, rows) integer codes; digits (S, k_tiles, rows, N)
    logical (un-nibbled) digits, integer or float32 (planes carrying cell
    variation); s_p, deq (S, k_tiles, N). Returns (M, N) float32.

    The MACs run in float64 whatever TF32 setting is active, then round
    once to float32. For integer digits the sums are exact. For float32
    digits each code x digit product is exact in float64 and so, for the
    code and digit ranges of a CIM array, is their sum; so float digits
    need no other arithmetic, and the kernel's float64 accumulation
    matches this bit for bit."""
    psum = _psum(a_t, digits)
    if psum_quant:
        psum = adc_quantize_ref(psum, s_p.to(torch.float32)[None], psum_bits)
    return shift_add(psum, deq.to(torch.float32))


def cim_matmul_experts_ref(a_t: torch.Tensor, digits: torch.Tensor,
                           s_p: torch.Tensor, deq: torch.Tensor, *,
                           psum_bits: int,
                           psum_quant: bool = True) -> torch.Tensor:
    """The CIM matmul of every expert of an MoE bank: ``cim_matmul_ref`` on
    each expert's slice, in the port's order (t outer, s inner).

    a_t (E, C, k_tiles, rows) integer codes; digits (E, S, k_tiles, rows,
    N) logical digits; s_p, deq (E, S, k_tiles, N). Returns (E, C, N)
    float32."""
    return torch.stack([
        cim_matmul_ref(a_t[e], digits[e], s_p[e], deq[e], psum_bits=psum_bits,
                       psum_quant=psum_quant)
        for e in range(a_t.shape[0])])


def cim_matmul_adc_free_ref(a_t: torch.Tensor, digits: torch.Tensor,
                            deq: torch.Tensor) -> torch.Tensor:
    """ADC-free CIM matmul: the partial sums leave the array exact and are
    accumulated digitally, so there is no ADC stage and no s_p operand:
    ``out = sum_t sum_s round(psum) * deq`` in the port's shift-and-add
    order (t outer, s inner), float64 MACs as in ``cim_matmul_ref``.
    On integer digits ``round`` is the identity, so this equals
    ``cim_matmul_ref`` with ``psum_quant=False`` bit for bit."""
    return shift_add(torch.round(_psum(a_t, digits)), deq.to(torch.float32))


def _psum(a_t: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """(M, S, kt, N) float32 partial sums from float64 MACs."""
    return torch.einsum("mtr,strn->mstn", a_t.to(torch.float64),
                        digits.to(torch.float64)).to(torch.float32)


def conv_pads(h: int, w: int, kh: int, kw: int, stride: int, padding):
    """Resolve a padding spec to explicit ((lo, hi), (lo, hi)) pairs, by
    XLA's rule for "SAME"/"VALID": out = ceil(in / stride), total =
    max((out - 1) * stride + k - in, 0), lo = total // 2."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0), (0, 0))
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for size, k in ((h, kh), (w, kw)):
            out = math.ceil(size / stride)
            total = max((out - 1) * stride + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def extract_conv_patches(a: torch.Tensor, kh: int, kw: int, stride: int,
                         padding, k_tiles: int,
                         c_per_array: int) -> torch.Tensor:
    """Stretched-kernel patches (paper §III-C): (B, H, W, C) ->
    (B, H', W', k_tiles, kh*kw*c_per_array), each tile's rows flattened
    tap-major (dh, dw, c), channels zero-padded to k_tiles*c_per_array.
    Keeps the input dtype."""
    b, h, w, c = a.shape
    (ph_lo, ph_hi), (pw_lo, pw_hi) = conv_pads(h, w, kh, kw, stride, padding)
    c_pad = k_tiles * c_per_array - c
    a = F.pad(a, (0, c_pad, pw_lo, pw_hi, ph_lo, ph_hi))
    hp, wp = h + ph_lo + ph_hi, w + pw_lo + pw_hi
    ho = (hp - kh) // stride + 1
    wo = (wp - kw) // stride + 1
    taps = [a[:, dh: dh + (ho - 1) * stride + 1: stride,
              dw: dw + (wo - 1) * stride + 1: stride, :]
            for dh in range(kh) for dw in range(kw)]
    p = torch.stack(taps, dim=3)                    # (B,H',W',taps,kt*cpa)
    p = p.reshape(b, ho, wo, kh * kw, k_tiles, c_per_array)
    p = p.permute(0, 1, 2, 4, 3, 5)                 # (B,H',W',kt,taps,cpa)
    return p.reshape(b, ho, wo, k_tiles, kh * kw * c_per_array)


def cim_conv_ref(a_int: torch.Tensor, digits: torch.Tensor, s_p: torch.Tensor,
                 deq: torch.Tensor, *, kh: int, kw: int, stride: int, padding,
                 c_per_array: int, psum_bits: int,
                 psum_quant: bool = True) -> torch.Tensor:
    """CIM conv: stretched-kernel patches, then ``cim_matmul_ref`` per output
    position. digits (S, k_tiles, kh*kw*cpa, C_out) logical. Returns
    (B, H', W', C_out) float32."""
    return conv_as_matmul(
        a_int, digits, kh, kw, stride, padding, c_per_array,
        lambda a2: cim_matmul_ref(a2, digits, s_p, deq, psum_bits=psum_bits,
                                  psum_quant=psum_quant))


def cim_conv_adc_free_ref(a_int: torch.Tensor, digits: torch.Tensor,
                          deq: torch.Tensor, *, kh: int, kw: int, stride: int,
                          padding, c_per_array: int) -> torch.Tensor:
    """ADC-free CIM conv: the same patches, then ``cim_matmul_adc_free_ref``.
    Returns (B, H', W', C_out) float32."""
    return conv_as_matmul(
        a_int, digits, kh, kw, stride, padding, c_per_array,
        lambda a2: cim_matmul_adc_free_ref(a2, digits, deq))


def conv_as_matmul(a_int, digits, kh, kw, stride, padding, c_per_array,
                   matmul):
    """Stretched-kernel patches flattened to M = B*H'*W' rows, through
    ``matmul``, back to (B, H', W', C_out). ``digits`` may be logical or
    nibble planes: only its k_tiles and C_out are read."""
    k_tiles = digits.shape[1]
    a_t = extract_conv_patches(a_int, kh, kw, stride, padding, k_tiles,
                               c_per_array)
    b, ho, wo = a_t.shape[:3]
    out = matmul(a_t.reshape(b * ho * wo, k_tiles, a_t.shape[-1]))
    return out.reshape(b, ho, wo, digits.shape[-1])
