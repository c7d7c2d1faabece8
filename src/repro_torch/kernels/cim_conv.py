"""Fused CIM conv deploy path: the port of
``repro/kernels/cim_conv.py::cim_conv_pallas``.

Stretched-kernel patches (B, H', W', k_tiles, kh*kw*c_per_array) are taken
once, in plain PyTorch as the reference takes them outside its Pallas
kernel, then the spatial axes flatten to M = B*H'*W' and the patches go
through the fused CIM matmul kernel (``cim_matmul_cuda``) with
``nibble_groups = kh*kw``: each tap is its own packed nibble block in the
flattened row layout. No n_split replication of the activations and no
partial-sum tensor in device memory.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version, ``ref.cim_conv_ref``. ``cim_conv_cuda.launches`` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.nibble import unpack_nibbles

from . import ref
from .cim_matmul import cim_matmul_cuda


def cim_conv_cuda(a_int: torch.Tensor, digits: torch.Tensor,
                  s_p: torch.Tensor, deq: torch.Tensor,
                  occ: torch.Tensor | None = None, *, kh: int, kw: int,
                  stride: int, padding, c_per_array: int, psum_bits: int,
                  psum_quant: bool = True) -> torch.Tensor:
    """a_int (B, H, W, C_in) int8/uint8 codes; digits (S, k_tiles,
    kh*kw*cpa, C_out) int8 or nibble uint8 (S, k_tiles, kh*kw*cpa/2,
    C_out). Returns (B, H', W', C_out) float32."""
    n_split, k_tiles, rows_d, n = digits.shape
    rows = kh * kw * c_per_array
    nibble = digits.dtype == torch.uint8
    if rows_d != (rows // 2 if nibble else rows):
        raise ValueError(f"cim_conv_cuda: planes {tuple(digits.shape)} do not "
                         f"match kh={kh}, kw={kw}, c_per_array={c_per_array}")
    if a_int.device.type == "cpu":
        d = unpack_nibbles(digits, groups=kh * kw) if nibble else digits
        return ref.cim_conv_ref(a_int, d, s_p, deq, kh=kh, kw=kw,
                                stride=stride, padding=padding,
                                c_per_array=c_per_array, psum_bits=psum_bits,
                                psum_quant=psum_quant)
    if a_int.device.type != "cuda":
        raise ValueError(f"cim_conv_cuda: unsupported device {a_int.device}")
    a_t = ref.extract_conv_patches(a_int, kh, kw, stride, padding, k_tiles,
                                   c_per_array)
    b, ho, wo = a_t.shape[:3]
    out = cim_matmul_cuda(a_t.reshape(b * ho * wo, k_tiles, rows), digits,
                          s_p, deq, occ, psum_bits=psum_bits,
                          psum_quant=psum_quant, nibble_groups=kh * kw)
    cim_conv_cuda.launches += 1
    return out.reshape(b, ho, wo, n)


cim_conv_cuda.launches = 0
