"""Plain PyTorch versions of the CIM kernels (counterpart of
``repro.kernels.ref``).

They define the arithmetic the CUDA kernels in ``csrc/`` (the FP64
tensor-core kernel ``cim_matmul.cu`` for float32 planes and the int8
tensor-core ``cim_matmul_mma.cu`` and ``cim_adc_free_mma.cu``) must
reproduce (with the ADC, ADC-free,
and batched over MoE experts), run on the CPU and on the card, and are
what the wrappers use for CPU tensors. The shift-and-add accumulates in
the kernel's order (array tile outer, split inner, one rounded multiply
and one rounded add per term), so the kernel and this version agree bit
for bit.

``ordered_sum`` mirrors the ordered pass that adds a split tile loop's
terms (``shift_add_terms``). ``conv_geometry`` gives the implicit-GEMM
conv kernels their launch arguments, and ``implicit_conv_rows`` mirrors
their index map (output row -> pixel, logical row -> tap and channel)
in plain torch.
``extract_conv_patches.cuda_gathers`` counts patch gathers run on a CUDA
tensor, so a run can show that a conv path gathered nothing in torch
(``gather_conv_patches`` is the same gather, uncounted, for the ADC
collector's side-output, which counts its own). ``einsum_f32`` is an
einsum in full float32, never TF32.
"""
from __future__ import annotations

import dataclasses
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


def lsq_fake_quant_ref(x: torch.Tensor, s: torch.Tensor, qn: float,
                       qp: float) -> torch.Tensor:
    """LSQ fake-quant forward: clip(round(x / s), qn, qp) * s, s >= 1e-9."""
    s = torch.clamp_min(s, 1e-9)
    return torch.clamp(torch.round(x / s), qn, qp) * s


def shift_add(psum: torch.Tensor, deq: torch.Tensor) -> torch.Tensor:
    """Fused dequant and shift-and-add: (..., S, kt, N) quantized partial
    sums times (S, kt, N) scales, summed in the kernel's order (tile t
    outer, split s inner) into a float32 (..., N) output. Differentiable
    (``_ShiftAdd``)."""
    return _ShiftAdd.apply(psum, deq)


def _shift_add_loop(psum: torch.Tensor, deq: torch.Tensor) -> torch.Tensor:
    """``shift_add``'s forward: every term's product in one pass, laid out
    (kt, S, ..., N), then the ordered adds over contiguous terms."""
    n_split, k_tiles, n = deq.shape
    lead = tuple(psum.shape[:-3])
    terms = torch.empty((k_tiles, n_split) + lead + (n,),
                        dtype=torch.promote_types(psum.dtype, deq.dtype),
                        device=psum.device)
    torch.mul(psum.movedim(-2, 0).movedim(-2, 1),
              deq.transpose(0, 1).reshape(
                  (k_tiles, n_split) + (1,) * len(lead) + (n,)), out=terms)
    out = torch.zeros(lead + (n,), dtype=torch.float32, device=psum.device)
    for t in range(k_tiles):
        for s in range(n_split):
            out = out + terms[t, s]
    return out


class _ShiftAdd(torch.autograd.Function):
    """``shift_add`` with its gradients in one pass per operand: the
    partial sums' bit for bit as autograd gives them through the ordered
    loop of per-(split, tile) slices, the scales' summed over the rows at
    once. Autograd through the loop puts each slice's gradient into a
    zero tensor of the whole partial-sum shape and adds them up, S * kt
    passes over it: most of a train step's backward at kt 8-24."""

    @staticmethod
    def forward(ctx, psum, deq):
        ctx.save_for_backward(psum, deq)
        return _shift_add_loop(psum, deq)

    @staticmethod
    def backward(ctx, dout):
        psum, deq = ctx.saved_tensors
        dpsum = ddeq = None
        if ctx.needs_input_grad[0]:
            dpsum = dout[..., None, None, :] * deq
        if ctx.needs_input_grad[1]:
            ddeq = (dout[..., None, None, :] * psum).sum(
                dim=tuple(range(psum.ndim - 3)))
        return dpsum, ddeq


def shift_add_terms(psum: torch.Tensor, deq: torch.Tensor) -> torch.Tensor:
    """The terms of ``shift_add``, each its one rounded multiply: (kt, S,
    ..., N) float32, term[t, s] = psum[..., s, t, :] * deq[s, t]. What a
    block of the split tile loop (``csrc/cim_mma.cuh``) writes out."""
    n_split, k_tiles, _ = deq.shape
    return torch.stack([torch.stack([psum[..., s, t, :] * deq[s, t]
                                     for s in range(n_split)])
                        for t in range(k_tiles)])


def ordered_sum(terms: torch.Tensor) -> torch.Tensor:
    """(kt, S, ..., N) terms summed from 0.0 in the kernel's order, tile t
    outer, split s inner: the ordered pass after a split tile loop
    (``cim_ordered_sum_kernel``). ``ordered_sum(shift_add_terms(p, deq))``
    is ``shift_add(p, deq)`` bit for bit."""
    out = torch.zeros(tuple(terms.shape[2:]), dtype=torch.float32,
                      device=terms.device)
    for t in range(terms.shape[0]):
        for s in range(terms.shape[1]):
            out = out + terms[t, s]
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
                           psum_bits: int, psum_quant: bool = True,
                           counts: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The CIM matmul of every expert of an MoE bank: ``cim_matmul_ref`` on
    each expert's slice, in the port's order (t outer, s inner).

    a_t (E, C, k_tiles, rows) integer codes; digits (E, S, k_tiles, rows,
    N) logical digits; s_p, deq (E, S, k_tiles, N); counts optional (E,)
    integers: expert e's rows at or past counts[e] are taken as all-zero
    code rows (its empty capacity slots). Returns (E, C, N) float32."""
    if counts is not None:
        rows = torch.arange(a_t.shape[1], device=a_t.device)
        keep = rows[None] < counts.to(device=a_t.device,
                                      dtype=torch.int64)[:, None]
        a_t = torch.where(keep[:, :, None, None], a_t, torch.zeros_like(a_t))
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


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in full float32: on the card with TF32 matmuls off
    for the call (restored after)."""
    if not any(o.is_cuda for o in operands):
        return torch.einsum(eq, *operands)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum(eq, *operands)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """One CIM conv's shapes: input (batch, h, w, c_in) NHWC, kernel kh x
    kw at ``stride``, explicit ``pads`` ((top, bottom), (left, right)),
    output ho x wo, ``k_tiles`` array tiles of ``c_per_array`` channels."""

    batch: int
    h: int
    w: int
    c_in: int
    kh: int
    kw: int
    stride: int
    pads: tuple
    ho: int
    wo: int
    k_tiles: int
    c_per_array: int

    @property
    def m(self) -> int:
        """Output rows of the lowered matmul, B*H'*W'."""
        return self.batch * self.ho * self.wo

    @property
    def rows(self) -> int:
        """Logical rows of one array tile, kh*kw*c_per_array."""
        return self.kh * self.kw * self.c_per_array


def conv_geometry(shape, kh: int, kw: int, stride: int, padding,
                  k_tiles: int, c_per_array: int) -> ConvGeometry:
    """The geometry of a conv over NHWC codes of ``shape``: pads by
    ``conv_pads`` (XLA's rule), H' and W' as ``extract_conv_patches``
    computes them."""
    b, h, w, c = (int(v) for v in shape)
    pads = conv_pads(h, w, kh, kw, stride, padding)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
    ho = (h + ph_lo + ph_hi - kh) // stride + 1
    wo = (w + pw_lo + pw_hi - kw) // stride + 1
    return ConvGeometry(batch=b, h=h, w=w, c_in=c, kh=kh, kw=kw,
                        stride=stride, pads=pads, ho=ho, wo=wo,
                        k_tiles=k_tiles, c_per_array=c_per_array)


def implicit_conv_rows(a_int: torch.Tensor, m_idx, t: int, *, kh: int,
                       kw: int, stride: int, pads,
                       c_per_array: int) -> torch.Tensor:
    """Rows of array tile ``t`` of the stretched-kernel patches at output
    rows ``m_idx``, by the implicit-GEMM conv kernel's own index map: row
    m is (b, ho, wo) = (m // (H'W'), m % (H'W') // W', m % W'); logical row
    r is tap (dh, dw) = divmod(r // cpa, kw) and channel c = r % cpa; the
    code is a_int[b, ho*stride + dh - top, wo*stride + dw - left,
    t*cpa + c], zero outside the image and for channels >= C_in. Returns
    (len(m_idx), kh*kw*c_per_array) in a_int's dtype."""
    b_, h, w, c_in = a_int.shape
    (top, bottom), (left, right) = pads
    ho = (h + top + bottom - kh) // stride + 1
    wo = (w + left + right - kw) // stride + 1
    m = torch.as_tensor(m_idx, dtype=torch.int64, device=a_int.device)
    r = torch.arange(kh * kw * c_per_array, device=a_int.device)
    b, rem = m // (ho * wo), m % (ho * wo)
    oh, ow = rem // wo, rem % wo
    tap, c = r // c_per_array, r % c_per_array
    dh, dw = tap // kw, tap % kw
    hi = oh[:, None] * stride + dh[None] - top
    wi = ow[:, None] * stride + dw[None] - left
    ch = (t * c_per_array + c)[None].expand_as(hi)
    ok = ((hi >= 0) & (hi < h) & (wi >= 0) & (wi < w) & (ch < c_in)
          & (b[:, None] < b_))
    vals = a_int[b[:, None].clamp(max=b_ - 1), hi.clamp(0, h - 1),
                 wi.clamp(0, w - 1), ch.clamp(max=c_in - 1)]
    return torch.where(ok, vals, torch.zeros_like(vals))


def extract_conv_patches(a: torch.Tensor, kh: int, kw: int, stride: int,
                         padding, k_tiles: int,
                         c_per_array: int) -> torch.Tensor:
    """Stretched-kernel patches (paper §III-C): (B, H, W, C) ->
    (B, H', W', k_tiles, kh*kw*c_per_array), each tile's rows flattened
    tap-major (dh, dw, c), channels zero-padded to k_tiles*c_per_array.
    Keeps the input dtype. Counts its calls on a CUDA tensor in
    ``extract_conv_patches.cuda_gathers``."""
    extract_conv_patches.cuda_gathers += int(a.is_cuda)
    return gather_conv_patches(a, kh, kw, stride, padding, k_tiles,
                               c_per_array)


def gather_conv_patches(a: torch.Tensor, kh: int, kw: int, stride: int,
                        padding, k_tiles: int,
                        c_per_array: int) -> torch.Tensor:
    """``extract_conv_patches`` without its counter."""
    geo = conv_geometry(a.shape, kh, kw, stride, padding, k_tiles,
                        c_per_array)
    b, ho, wo = geo.batch, geo.ho, geo.wo
    (ph_lo, ph_hi), (pw_lo, pw_hi) = geo.pads
    a = F.pad(a, (0, k_tiles * c_per_array - geo.c_in, pw_lo, pw_hi, ph_lo,
                  ph_hi))
    taps = [a[:, dh: dh + (ho - 1) * stride + 1: stride,
              dw: dw + (wo - 1) * stride + 1: stride, :]
            for dh in range(kh) for dw in range(kw)]
    p = torch.stack(taps, dim=3)                    # (B,H',W',taps,kt*cpa)
    p = p.reshape(b, ho, wo, kh * kw, k_tiles, c_per_array)
    p = p.permute(0, 1, 2, 4, 3, 5)                 # (B,H',W',kt,taps,cpa)
    return p.reshape(b, ho, wo, k_tiles, kh * kw * c_per_array)


extract_conv_patches.cuda_gathers = 0


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
