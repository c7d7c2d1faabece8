"""Single-device dispatch around the CIM kernels (counterpart of the
single-device branches of ``repro.kernels.ops``).

``use_kernel=True`` goes to the kernel wrappers, which launch the CUDA
kernel for a CUDA tensor (or raise) and run the plain version for a CPU
tensor. ``use_kernel=False`` runs the plain version (``kernels.ref``) on
whatever device the tensors are on. The mesh, telemetry, ADC-free and
variation branches of the reference come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.core.nibble import unpack_nibbles

from . import ref
from .cim_conv import cim_conv_cuda
from .cim_matmul import cim_matmul_cuda


def cim_matmul(a_t: torch.Tensor, digits: torch.Tensor, s_p: torch.Tensor,
               deq: torch.Tensor, *, psum_bits: int, psum_quant: bool = True,
               use_kernel: bool = True,
               occ: torch.Tensor | None = None) -> torch.Tensor:
    """CIM matmul over pre-tiled inputs.

    a_t (..., k_tiles, rows) integer codes; digits (S, k_tiles, rows, N)
    int8 or nibble uint8 (S, k_tiles, rows // 2, N); s_p, deq (S, k_tiles,
    N); occ optional (S, k_tiles, N) occupancy map (the plain version
    ignores it: the sparse kernel is bit-exact with the dense arithmetic).
    Returns (..., N) float32."""
    batch_shape = tuple(a_t.shape[:-2])
    a2 = a_t.reshape((-1,) + tuple(a_t.shape[-2:]))
    if use_kernel:
        out = cim_matmul_cuda(a2, digits, s_p, deq, occ, psum_bits=psum_bits,
                              psum_quant=psum_quant)
    else:
        if digits.dtype == torch.uint8:
            digits = unpack_nibbles(digits)
        out = ref.cim_matmul_ref(a2, digits, s_p, deq, psum_bits=psum_bits,
                                 psum_quant=psum_quant)
    return out.reshape(batch_shape + (digits.shape[-1],))


def cim_conv(a_int: torch.Tensor, digits: torch.Tensor, s_p: torch.Tensor,
             deq: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
             padding="SAME", c_per_array: int, psum_bits: int,
             psum_quant: bool = True, use_kernel: bool = True,
             occ: torch.Tensor | None = None) -> torch.Tensor:
    """CIM conv over activation codes (B, H, W, C_in) and packed conv planes
    (S, k_tiles, kh*kw*c_per_array, C_out), or their nibble form with each
    tap its own packed block. Returns (B, H', W', C_out) float32."""
    if use_kernel:
        return cim_conv_cuda(a_int, digits, s_p, deq, occ, kh=kh, kw=kw,
                             stride=stride, padding=padding,
                             c_per_array=c_per_array, psum_bits=psum_bits,
                             psum_quant=psum_quant)
    if digits.dtype == torch.uint8:
        digits = unpack_nibbles(digits, groups=kh * kw)
    return ref.cim_conv_ref(a_int, digits, s_p, deq, kh=kh, kw=kw,
                            stride=stride, padding=padding,
                            c_per_array=c_per_array, psum_bits=psum_bits,
                            psum_quant=psum_quant)
