"""ADC-free CIM matmul and conv (the ``adc_free`` hardware style): the
port of ``repro/kernels/cim_adc_free.py::cim_matmul_adc_free_pallas`` and
``cim_conv_adc_free_pallas``.

Each (split, array tile, column) partial sum leaves the array exact and is
accumulated digitally: ``out = sum_t sum_s round(psum) * deq``, with no ADC
stage and no s_p operand.

Dispatch on the planes' dtype, for CUDA tensors:
- integer planes (int8, or int4 nibble pairs in uint8) run the
  tensor-core kernels of ``csrc/cim_adc_free_mma.cu``: the matmul on
  pre-tiled codes (``cim_matmul_adc_free_mma_launch``), and the conv as an
  implicit GEMM that gathers its stretched-kernel patch rows from the NHWC
  codes inside the kernel (``cim_conv_adc_free_implicit_launch``, through
  ``cim_conv.implicit_conv``, the launch every CIM conv shares), so no
  patch tensor is made;
- float32 planes (cell variation) run the FP64 tensor-core kernel of
  ``csrc/cim_matmul.cu``: the matmul (``cim_matmul_adc_free_launch``), and
  the conv as an implicit GEMM too (``cim_conv_float_implicit_launch``).
A refused launch raises. A CPU tensor runs the plain versions
``ref.cim_matmul_adc_free_ref`` / ``ref.cim_conv_adc_free_ref``.

The tensor-core kernels read the integer planes relaid K-major (nibbles
decoded) into a device workspace kept per plane tensor
(``kernels/relaid.py``): a launch inside a CUDA-graph capture raises if it
would relay kept planes (run the call once before capturing it).

Counters: each wrapper's ``launches`` and, of them, ``float_launches`` on
float32 planes.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .cim_conv import check_planes, implicit_conv
from .cim_matmul import (check_float_exact, float_workspace,
                         kernel_operands, logical_digits, raise_on_error)
from .relaid import check_capture, relaid_planes

_MMA = "cim_adc_free_mma"


def cim_matmul_adc_free_cuda(a_t: torch.Tensor, digits: torch.Tensor,
                             deq: torch.Tensor,
                             occ: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """out (M, N) float32 = sum_t sum_s deq * round(a_t[:, t] @ d[s, t]).

    Operands as ``cim_matmul_cuda`` without ``s_p``: a_t (M, k_tiles,
    rows) int8/uint8 codes; digits (S, k_tiles, rows, N) int8 or float32,
    or nibble uint8 (S, k_tiles, rows // 2, N); deq (S, k_tiles, N); occ
    optional (S, k_tiles, N) uint8."""
    if a_t.device.type == "cpu":
        return ref.cim_matmul_adc_free_ref(a_t, logical_digits(digits), deq)
    op = kernel_operands("cim_matmul_adc_free_cuda", a_t, digits, occ,
                         deq=deq)
    if op.m == 0:
        return op.out
    floats = digits.dtype == torch.float32
    lib = _build.load("cim_matmul" if floats else _MMA)
    occ_ptr = op.occ.data_ptr() if op.occ is not None else None
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream(a_t.device).cuda_stream
        if floats:
            check_float_exact("cim_matmul_adc_free_cuda", digits,
                              op.a_unsigned)
            work = float_workspace(lib, a_t.device, op.k_tiles, op.n_split,
                                   op.n, 1, op.rows)
            rc = lib.cim_matmul_adc_free_launch(
                a_t.data_ptr(), digits.data_ptr(), occ_ptr,
                op.cols["deq"].data_ptr(), op.out.data_ptr(), work.data_ptr(),
                work.numel(), *op.shape_args(), op.a_unsigned, stream)
        else:
            work, layout, kept = relaid_planes(
                digits, lib.cim_adc_free_mma_workspace(
                    op.k_tiles, op.n_split, op.n, 1, op.rows),
                (1, op.rows, op.k_tiles * op.rows))
            rc = lib.cim_matmul_adc_free_mma_launch(
                a_t.data_ptr(), digits.data_ptr(), occ_ptr,
                op.cols["deq"].data_ptr(), op.out.data_ptr(),
                work.data_ptr(), work.numel(), ctypes.byref(layout),
                *op.shape_args(), op.a_unsigned, op.nibble, stream)
    if floats:
        raise_on_error(lib, rc, "cim_matmul_adc_free")
    else:
        raise_on_error(lib, rc, "cim_matmul_adc_free_mma",
                       "cim_adc_free_mma_error_string")
        check_capture(layout, kept, "cim_matmul_adc_free_cuda")
    cim_matmul_adc_free_cuda.launches += 1
    cim_matmul_adc_free_cuda.float_launches += int(floats)
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
    check_planes("cim_conv_adc_free_cuda", digits, kh, kw, c_per_array)
    if a_int.device.type == "cpu":
        return ref.cim_conv_adc_free_ref(
            a_int, logical_digits(digits, kh * kw), deq, kh=kh, kw=kw,
            stride=stride, padding=padding, c_per_array=c_per_array)
    out = implicit_conv(
        "cim_conv_adc_free_cuda", a_int, digits, deq, occ,
        ref.conv_geometry(a_int.shape, kh, kw, stride, padding,
                          digits.shape[1], c_per_array))
    cim_conv_adc_free_cuda.launches += 1
    cim_conv_adc_free_cuda.float_launches += int(digits.dtype == torch.float32)
    return out


cim_conv_adc_free_cuda.launches = 0
cim_conv_adc_free_cuda.float_launches = 0
