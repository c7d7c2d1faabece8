"""Fused CIM conv deploy path: the port of
``repro/kernels/cim_conv.py::cim_conv_pallas``, and the implicit-GEMM
launch that every CIM conv of the port shares.

The reference takes stretched-kernel patches (B, H', W', k_tiles,
kh*kw*c_per_array) outside its Pallas kernel and runs the CIM matmul on
them with M = B*H'*W'. Here the kernel gathers the patch rows itself from
the NHWC codes (implicit GEMM; pads, H' and W' from ``ref.conv_geometry``,
the index map mirrored by ``ref.implicit_conv_rows``), so no patch tensor
is made. ``implicit_conv`` dispatches on the planes' dtype and the ADC:
- integer planes (int8, or int4 nibble pairs in uint8) run the int8
  tensor-core kernels of the core ``csrc/cim_mma.cuh``: with the ADC
  ``cim_conv_mma_implicit_launch`` (``csrc/cim_matmul_mma.cu``), ADC-free
  ``cim_conv_adc_free_implicit_launch`` (``csrc/cim_adc_free_mma.cu``).
  Both read the planes relaid into one kept workspace per plane tensor
  (``kernels/relaid.py``; the same layout, so a pack run on deploy and on
  adc_free is relaid once); a launch inside a CUDA-graph capture raises
  if it would relay kept planes (run the call once before capturing it);
- float32 planes (cell variation, drift) run the FP64 tensor-core kernel
  of ``csrc/cim_matmul.cu`` (``cim_conv_float_implicit_launch``, ADC or
  ADC-free); they are drawn fresh for each sample and staged per launch.
  Before the launch ``cim_matmul.check_float_exact`` shows from the
  planes that every tile's float64 sum is exact in any order (whatever
  the tile's rows: the whisper stems' 126, llava's patch embed's 196),
  and raises with the conv's shape where it cannot.
A refused launch raises; nothing falls back to a torch gather.

``cim_conv_cuda`` is K3: a CUDA tensor launches the kernel or raises; a
CPU tensor runs the plain version, ``ref.cim_conv_ref``.
``cim_conv_cuda.launches`` counts launches, ``cim_conv_cuda.float_launches``
those on float32 (cell-variation) planes.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .cim_matmul import (check_float_exact, float_workspace,
                         logical_digits, raise_on_error)
from .relaid import check_capture, relaid_planes


def cim_conv_cuda(a_int: torch.Tensor, digits: torch.Tensor,
                  s_p: torch.Tensor, deq: torch.Tensor,
                  occ: torch.Tensor | None = None, *, kh: int, kw: int,
                  stride: int, padding, c_per_array: int, psum_bits: int,
                  psum_quant: bool = True) -> torch.Tensor:
    """a_int (B, H, W, C_in) int8/uint8 codes; digits (S, k_tiles,
    kh*kw*cpa, C_out) int8 or float32 (cell variation), or nibble uint8
    (S, k_tiles, kh*kw*cpa/2, C_out). Returns (B, H', W', C_out)
    float32."""
    check_planes("cim_conv_cuda", digits, kh, kw, c_per_array)
    if a_int.device.type == "cpu":
        return ref.cim_conv_ref(a_int, logical_digits(digits, kh * kw), s_p,
                                deq, kh=kh, kw=kw,
                                stride=stride, padding=padding,
                                c_per_array=c_per_array, psum_bits=psum_bits,
                                psum_quant=psum_quant)
    out = implicit_conv(
        "cim_conv_cuda", a_int, digits, deq, occ,
        ref.conv_geometry(a_int.shape, kh, kw, stride, padding,
                          digits.shape[1], c_per_array),
        s_p=s_p, psum_bits=psum_bits, psum_quant=psum_quant)
    cim_conv_cuda.launches += 1
    cim_conv_cuda.float_launches += int(digits.dtype == torch.float32)
    return out


cim_conv_cuda.launches = 0
cim_conv_cuda.float_launches = 0


def check_planes(name: str, digits: torch.Tensor, kh: int, kw: int,
                 c_per_array: int) -> None:
    """Raise unless the planes' rows are kh*kw*c_per_array (half of it for
    nibble planes)."""
    rows = kh * kw * c_per_array
    if digits.ndim != 4 or digits.shape[2] != (
            rows // 2 if digits.dtype == torch.uint8 else rows):
        raise ValueError(f"{name}: planes {tuple(digits.shape)} do not match "
                         f"kh={kh}, kw={kw}, c_per_array={c_per_array}")


def implicit_conv(name: str, a_int: torch.Tensor, digits: torch.Tensor,
                  deq: torch.Tensor, occ: torch.Tensor | None,
                  geo: ref.ConvGeometry, *, s_p: torch.Tensor | None = None,
                  psum_bits: int = 0, psum_quant: bool = False
                  ) -> torch.Tensor:
    """One launch of an implicit-GEMM CIM conv kernel on checked operands:
    with the ADC where ``s_p`` is given (``psum_bits``, ``psum_quant``),
    else ADC-free; integer or float32 planes (rows checked by the
    caller). ``name`` names the wrapper in errors. Returns (B, H', W',
    C_out) float32."""
    if a_int.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"{name}: activation codes must be int8 or uint8, "
                        f"got {a_int.dtype}")
    if digits.dtype not in (torch.int8, torch.uint8, torch.float32):
        raise TypeError(f"{name}: digit planes must be int8, nibble uint8 or "
                        f"float32 (cell variation), got {digits.dtype}")
    if a_int.ndim != 4 or digits.ndim != 4:
        raise ValueError(f"{name}: codes {tuple(a_int.shape)} and planes "
                         f"{tuple(digits.shape)} have the wrong rank")
    n_split, k_tiles, _, n = digits.shape
    if k_tiles * geo.c_per_array < geo.c_in:
        raise ValueError(f"{name}: {k_tiles} tiles of {geo.c_per_array} "
                         f"channels do not cover C_in = {geo.c_in}")
    shape = (n_split, k_tiles, n)
    cols = {"deq": deq} if s_p is None else {"s_p": s_p, "deq": deq}
    for nm, v in tuple(cols.items()) + ((("occ", occ),) if occ is not None
                                        else ()):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: {nm} has shape {tuple(v.shape)}, "
                             f"expected {shape}")
    if not (a_int.is_contiguous() and digits.is_contiguous()):
        raise ValueError(f"{name}: a_int and digits must be contiguous")
    dev = a_int.device
    if digits.device != dev:
        raise ValueError(f"{name}: operands on different devices")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    cols = {k: v.to(device=dev, dtype=torch.float32).contiguous()
            for k, v in cols.items()}
    if occ is not None:
        occ = occ.to(device=dev, dtype=torch.uint8).contiguous()
    out = torch.empty((geo.batch, geo.ho, geo.wo, n), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    (top, _), (left, _) = geo.pads
    adc = s_p is not None
    sizes = (geo.batch, geo.h, geo.w, geo.c_in, geo.kh, geo.kw, geo.stride,
             top, left, geo.ho, geo.wo, geo.c_per_array, k_tiles, n_split, n)
    ptrs = (a_int.data_ptr(), digits.data_ptr(),
            occ.data_ptr() if occ is not None else None)
    sp_ptr = cols["s_p"].data_ptr() if adc else None
    a_unsigned = int(a_int.dtype == torch.uint8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if digits.dtype == torch.float32:
            check_float_exact(
                name, digits, bool(a_unsigned),
                f"conv {geo.kh}x{geo.kw} stride {geo.stride} on codes "
                f"{tuple(a_int.shape)}, {geo.c_per_array} channels per "
                f"array: tiles of {geo.kh * geo.kw * geo.c_per_array} rows")
            lib = _build.load("cim_matmul")
            work = float_workspace(lib, dev, k_tiles, n_split, n,
                                   geo.kh * geo.kw, geo.c_per_array)
            rc = lib.cim_conv_float_implicit_launch(
                *ptrs, sp_ptr, cols["deq"].data_ptr(), out.data_ptr(),
                work.data_ptr(), work.numel(), *sizes, a_unsigned, int(adc),
                psum_bits, int(psum_quant), stream)
            raise_on_error(lib, rc, "cim_conv_float_implicit")
            return out
        taps, lib_name = geo.kh * geo.kw, ("cim_matmul_mma" if adc
                                          else "cim_adc_free_mma")
        lib = _build.load(lib_name)
        nbytes = (lib.cim_matmul_mma_workspace(k_tiles, n_split, n, taps,
                                               geo.c_per_array, 1) if adc
                  else lib.cim_adc_free_mma_workspace(k_tiles, n_split, n,
                                                      taps, geo.c_per_array))
        work, layout, kept = relaid_planes(
            digits, nbytes, (taps, geo.c_per_array, geo.c_in))
        nibble = int(digits.dtype == torch.uint8)
        if adc:
            rc = lib.cim_conv_mma_implicit_launch(
                *ptrs, sp_ptr, cols["deq"].data_ptr(), out.data_ptr(),
                work.data_ptr(), work.numel(), ctypes.byref(layout), *sizes,
                a_unsigned, nibble, psum_bits, int(psum_quant), stream)
        else:
            rc = lib.cim_conv_adc_free_implicit_launch(
                *ptrs, cols["deq"].data_ptr(), out.data_ptr(),
                work.data_ptr(), work.numel(), ctypes.byref(layout), *sizes,
                a_unsigned, nibble, stream)
    raise_on_error(lib, rc, ("cim_conv_mma_implicit" if adc
                             else "cim_conv_adc_free_implicit"),
                   f"{lib_name}_error_string")
    check_capture(layout, kept, name)
    return out


def window_mode(geo: ref.ConvGeometry, n_split: int, n: int) -> bool:
    """Whether the tensor-core implicit conv (K3, K5) runs a conv of this
    geometry in window mode (each row block copies its input window once)
    rather than on the staged path of the same kernel, for codes at a
    16-byte aligned address. Builds the kernels' library."""
    (top, _), (left, _) = geo.pads
    mode = _build.load("cim_matmul_mma").cim_conv_mma_window_mode(
        geo.batch, geo.h, geo.w, geo.c_in, geo.kh, geo.kw, geo.stride, top,
        left, geo.ho, geo.wo, geo.c_per_array, geo.k_tiles, n_split, n)
    if mode < 0:
        raise ValueError(f"window_mode: sizes out of range: {geo}")
    return bool(mode)
