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
  codes inside the kernel (``cim_conv_adc_free_implicit_launch``; pads, H'
  and W' from ``ref.conv_geometry``), so no patch tensor is made;
- float32 planes (cell variation) run the float64 branch of
  ``csrc/cim_matmul.cu`` (``cim_matmul_adc_free_launch``), the conv on
  patches gathered in plain torch (``ref.conv_as_matmul``).
A refused launch raises. A CPU tensor runs the plain versions
``ref.cim_matmul_adc_free_ref`` / ``ref.cim_conv_adc_free_ref``.

The tensor-core kernels read the planes relaid K-major (nibbles decoded)
into a device workspace kept per plane tensor (``kernels/relaid.py``): a
launch inside a CUDA-graph capture raises if it would relay kept planes
(run the call once before capturing it).

Counters: each wrapper's ``launches`` and, of them, ``float_launches`` on
float32 planes. The conv's float-plane launches also count on the
matmul's, which runs them; its integer launches do not.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .cim_matmul import kernel_operands, logical_digits, raise_on_error
from .relaid import check_capture, relaid_planes

_MMA = "cim_adc_free_mma"


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
    floats = digits.dtype == torch.float32
    lib = _build.load("cim_matmul" if floats else _MMA)
    occ_ptr = op.occ.data_ptr() if op.occ is not None else None
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream(a_t.device).cuda_stream
        if floats:
            rc = lib.cim_matmul_adc_free_launch(
                a_t.data_ptr(), digits.data_ptr(), occ_ptr,
                op.cols["deq"].data_ptr(), op.out.data_ptr(),
                *op.shape_args(), op.a_unsigned, stream)
        else:
            work, layout, kept = relaid_planes(
                digits, lib.cim_adc_free_mma_workspace(
                    op.k_tiles, op.n_split, op.n, 1, op.rows),
                (1, op.rows, op.k_tiles * op.rows))
            rc = lib.cim_matmul_adc_free_mma_launch(
                a_t.data_ptr(), digits.data_ptr(), occ_ptr,
                op.cols["deq"].data_ptr(), op.out.data_ptr(),
                work.data_ptr(), work.numel(), ctypes.byref(layout),
                *op.shape_args(), nibble_groups, op.a_unsigned, op.nibble,
                stream)
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
    floats = digits.dtype == torch.float32
    if floats:
        out = ref.conv_as_matmul(
            a_int, digits, kh, kw, stride, padding, c_per_array,
            lambda a_t: cim_matmul_adc_free_cuda(a_t, digits, deq, occ,
                                                 nibble_groups=kh * kw))
    else:
        out = _implicit_conv(a_int, digits, deq, occ, ref.conv_geometry(
            a_int.shape, kh, kw, stride, padding, digits.shape[1],
            c_per_array))
    cim_conv_adc_free_cuda.launches += 1
    cim_conv_adc_free_cuda.float_launches += int(floats)
    return out


cim_conv_adc_free_cuda.launches = 0
cim_conv_adc_free_cuda.float_launches = 0


def _implicit_conv(a_int, digits, deq, occ, geo: ref.ConvGeometry):
    """One launch of the implicit-GEMM conv kernel on checked operands."""
    name = "cim_conv_adc_free_cuda"
    if a_int.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"{name}: activation codes must be int8 or uint8, "
                        f"got {a_int.dtype}")
    if digits.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"{name}: integer planes must be int8 or nibble "
                        f"uint8, got {digits.dtype}")
    if a_int.ndim != 4 or digits.ndim != 4:
        raise ValueError(f"{name}: codes {tuple(a_int.shape)} and planes "
                         f"{tuple(digits.shape)} have the wrong rank")
    n_split, k_tiles, _, n = digits.shape      # rows checked by the caller
    if k_tiles * geo.c_per_array < geo.c_in:
        raise ValueError(f"{name}: {k_tiles} tiles of {geo.c_per_array} "
                         f"channels do not cover C_in = {geo.c_in}")
    shape = (n_split, k_tiles, n)
    for nm, v in (("deq", deq),) + ((("occ", occ),) if occ is not None
                                    else ()):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: {nm} has shape {tuple(v.shape)}, "
                             f"expected {shape}")
    if not (a_int.is_contiguous() and digits.is_contiguous()):
        raise ValueError(f"{name}: a_int and digits must be contiguous")
    dev = a_int.device
    if digits.device != dev:
        raise ValueError(f"{name}: operands on different devices")
    deq = deq.to(device=dev, dtype=torch.float32).contiguous()
    if occ is not None:
        occ = occ.to(device=dev, dtype=torch.uint8).contiguous()
    out = torch.empty((geo.batch, geo.ho, geo.wo, n), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    (top, _), (left, _) = geo.pads
    lib = _build.load(_MMA)
    taps = geo.kh * geo.kw
    work, layout, kept = relaid_planes(
        digits, lib.cim_adc_free_mma_workspace(k_tiles, n_split, n, taps,
                                               geo.c_per_array),
        (taps, geo.c_per_array, geo.c_in))
    with torch.cuda.device(dev):
        rc = lib.cim_conv_adc_free_implicit_launch(
            a_int.data_ptr(), digits.data_ptr(),
            occ.data_ptr() if occ is not None else None, deq.data_ptr(),
            out.data_ptr(), work.data_ptr(), work.numel(),
            ctypes.byref(layout), geo.batch, geo.h,
            geo.w, geo.c_in, geo.kh, geo.kw, geo.stride, top, left, geo.ho,
            geo.wo, geo.c_per_array, k_tiles, n_split, n,
            int(a_int.dtype == torch.uint8),
            int(digits.dtype == torch.uint8),
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(lib, rc, "cim_conv_adc_free_implicit",
                   "cim_adc_free_mma_error_string")
    check_capture(layout, kept, name)
    return out

