"""ADC-free CIM matmul and conv (the ``adc_free`` hardware style): the
wrappers of the ADC-free kernel in ``csrc/cim_matmul.cu``
(``cim_matmul_adc_free_launch``), the port of
``repro/kernels/cim_adc_free.py::cim_matmul_adc_free_pallas`` and
``cim_conv_adc_free_pallas``.

Each (split, array tile, column) partial sum leaves the array exact and is
accumulated digitally: ``out = sum_t sum_s round(psum) * deq``, with no ADC
stage and no s_p operand. The conv lowers stretched-kernel patches onto the
matmul kernel, as ``kernels/cim_conv.py`` does, with ``nibble_groups =
kh*kw``.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
versions ``ref.cim_matmul_adc_free_ref`` / ``ref.cim_conv_adc_free_ref``.
Each wrapper carries its own ``launches`` count (and ``float_launches``
for float32 digit planes); the conv's launches also count on the matmul's.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .cim_matmul import kernel_operands, logical_digits, raise_on_error


def cim_matmul_adc_free_cuda(a_t: torch.Tensor, digits: torch.Tensor,
                             deq: torch.Tensor,
                             occ: torch.Tensor | None = None, *,
                             nibble_groups: int = 1) -> torch.Tensor:
    """out (M, N) float32 = sum_t sum_s deq * round(a_t[:, t] @ d[s, t]).

    Operands as ``cim_matmul_cuda`` without ``s_p``: a_t (M, k_tiles,
    rows) int8/uint8 codes; digits (S, k_tiles, rows, N) int8 or float32,
    or nibble uint8 (S, k_tiles, rows // 2, N); deq (S, k_tiles, N); occ
    optional (S, k_tiles, N) uint8."""
    if a_t.device.type == "cpu":
        return ref.cim_matmul_adc_free_ref(
            a_t, logical_digits(digits, nibble_groups), deq)
    op = kernel_operands("cim_matmul_adc_free_cuda", a_t, digits, occ,
                         deq=deq)
    if op.m == 0:
        return op.out
    lib = _build.load("cim_matmul")
    with torch.cuda.device(a_t.device):
        rc = lib.cim_matmul_adc_free_launch(
            a_t.data_ptr(), digits.data_ptr(),
            op.occ.data_ptr() if op.occ is not None else None,
            op.cols["deq"].data_ptr(), op.out.data_ptr(),
            *op.common_args(nibble_groups),
            torch.cuda.current_stream(a_t.device).cuda_stream)
    raise_on_error(lib, rc, "cim_matmul_adc_free")
    cim_matmul_adc_free_cuda.launches += 1
    cim_matmul_adc_free_cuda.float_launches += int(
        digits.dtype == torch.float32)
    return op.out


cim_matmul_adc_free_cuda.launches = 0
cim_matmul_adc_free_cuda.float_launches = 0


def cim_conv_adc_free_cuda(a_int: torch.Tensor, digits: torch.Tensor,
                           deq: torch.Tensor,
                           occ: torch.Tensor | None = None, *, kh: int,
                           kw: int, stride: int, padding,
                           c_per_array: int) -> torch.Tensor:
    """a_int (B, H, W, C_in) int8/uint8 codes; digits (S, k_tiles,
    kh*kw*cpa, C_out) int8 or float32, or nibble uint8 (S, k_tiles,
    kh*kw*cpa/2, C_out). Returns (B, H', W', C_out) float32."""
    rows_d, rows = digits.shape[2], kh * kw * c_per_array
    if rows_d != (rows // 2 if digits.dtype == torch.uint8 else rows):
        raise ValueError(f"cim_conv_adc_free_cuda: planes "
                         f"{tuple(digits.shape)} do not match kh={kh}, "
                         f"kw={kw}, c_per_array={c_per_array}")
    if a_int.device.type == "cpu":
        return ref.cim_conv_adc_free_ref(
            a_int, logical_digits(digits, kh * kw), deq, kh=kh, kw=kw,
            stride=stride, padding=padding, c_per_array=c_per_array)
    if a_int.device.type != "cuda":
        raise ValueError(f"cim_conv_adc_free_cuda: unsupported device "
                         f"{a_int.device}")
    out = ref.conv_as_matmul(
        a_int, digits, kh, kw, stride, padding, c_per_array,
        lambda a_t: cim_matmul_adc_free_cuda(a_t, digits, deq, occ,
                                             nibble_groups=kh * kw))
    cim_conv_adc_free_cuda.launches += 1
    cim_conv_adc_free_cuda.float_launches += int(
        digits.dtype == torch.float32)
    return out


cim_conv_adc_free_cuda.launches = 0
cim_conv_adc_free_cuda.float_launches = 0
