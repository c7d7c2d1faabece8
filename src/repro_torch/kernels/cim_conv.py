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
version, ``ref.cim_conv_ref``. ``cim_conv_cuda.launches`` counts launches,
``cim_conv_cuda.float_launches`` those on float32 (cell-variation) planes.
"""
from __future__ import annotations

import torch

from . import ref
from .cim_matmul import cim_matmul_cuda, logical_digits


def cim_conv_cuda(a_int: torch.Tensor, digits: torch.Tensor,
                  s_p: torch.Tensor, deq: torch.Tensor,
                  occ: torch.Tensor | None = None, *, kh: int, kw: int,
                  stride: int, padding, c_per_array: int, psum_bits: int,
                  psum_quant: bool = True) -> torch.Tensor:
    """a_int (B, H, W, C_in) int8/uint8 codes; digits (S, k_tiles,
    kh*kw*cpa, C_out) int8 or float32 (cell variation), or nibble uint8
    (S, k_tiles, kh*kw*cpa/2, C_out). Returns (B, H', W', C_out)
    float32."""
    rows_d, rows = digits.shape[2], kh * kw * c_per_array
    if rows_d != (rows // 2 if digits.dtype == torch.uint8 else rows):
        raise ValueError(f"cim_conv_cuda: planes {tuple(digits.shape)} do not "
                         f"match kh={kh}, kw={kw}, c_per_array={c_per_array}")
    if a_int.device.type == "cpu":
        return ref.cim_conv_ref(a_int, logical_digits(digits, kh * kw), s_p,
                                deq, kh=kh, kw=kw,
                                stride=stride, padding=padding,
                                c_per_array=c_per_array, psum_bits=psum_bits,
                                psum_quant=psum_quant)
    if a_int.device.type != "cuda":
        raise ValueError(f"cim_conv_cuda: unsupported device {a_int.device}")
    out = ref.conv_as_matmul(
        a_int, digits, kh, kw, stride, padding, c_per_array,
        lambda a_t: cim_matmul_cuda(a_t, digits, s_p, deq, occ,
                                    psum_bits=psum_bits,
                                    psum_quant=psum_quant,
                                    nibble_groups=kh * kw))
    cim_conv_cuda.launches += 1
    cim_conv_cuda.float_launches += int(digits.dtype == torch.float32)
    return out


cim_conv_cuda.launches = 0
cim_conv_cuda.float_launches = 0
