"""Fused CIM matmul with partial-sum (ADC) quantization: the wrapper of the
hand-written Hopper kernel ``csrc/cim_matmul.cu``, the port of
``repro/kernels/cim_matmul.py::cim_matmul_pallas`` (dense body, occupancy
skip and nibble decode in one kernel family).

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version, ``ref.cim_matmul_ref``. ``cim_matmul_cuda.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.nibble import unpack_nibbles

from . import _build, ref


def cim_matmul_cuda(a_t: torch.Tensor, digits: torch.Tensor,
                    s_p: torch.Tensor, deq: torch.Tensor,
                    occ: torch.Tensor | None = None, *, psum_bits: int,
                    psum_quant: bool = True,
                    nibble_groups: int = 1) -> torch.Tensor:
    """out (M, N) float32 = sum_t sum_s deq * ADC(a_t[:, t] @ digits[s, t]).

    a_t     (M, k_tiles, rows) int8 or uint8 activation codes
    digits  (S, k_tiles, rows, N) int8, or nibble-packed uint8
            (S, k_tiles, rows // 2, N) in ``nibble_groups`` half-split blocks
    s_p     (S, k_tiles, N) ADC scales
    deq     (S, k_tiles, N) fused dequant scales
    occ     optional (S, k_tiles, N) uint8 occupancy map of the planes
    """
    nibble = digits.dtype == torch.uint8
    if a_t.device.type == "cpu":
        d = unpack_nibbles(digits, groups=nibble_groups) if nibble else digits
        return ref.cim_matmul_ref(a_t, d, s_p, deq, psum_bits=psum_bits,
                                  psum_quant=psum_quant)
    if a_t.device.type != "cuda":
        raise ValueError(f"cim_matmul_cuda: unsupported device {a_t.device}")
    if digits.dtype not in (torch.int8, torch.uint8):
        raise NotImplementedError(
            f"cim_matmul_cuda: digit planes of dtype {digits.dtype} (float "
            "planes carry cell variation, which is not ported yet)")
    if a_t.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"cim_matmul_cuda: activation codes must be int8 or "
                        f"uint8, got {a_t.dtype}")
    m, k_tiles, rows = a_t.shape
    n_split, kt_d, rows_d, n = digits.shape
    if kt_d != k_tiles or rows_d != (rows // 2 if nibble else rows):
        raise ValueError(f"cim_matmul_cuda: planes {tuple(digits.shape)} do "
                         f"not match activations {tuple(a_t.shape)}")
    cols = (n_split, k_tiles, n)
    for nm, v in (("s_p", s_p), ("deq", deq)) + ((("occ", occ),) if occ is
                                                  not None else ()):
        if tuple(v.shape) != cols:
            raise ValueError(f"cim_matmul_cuda: {nm} has shape "
                             f"{tuple(v.shape)}, expected {cols}")
    if not (a_t.is_contiguous() and digits.is_contiguous()):
        raise ValueError("cim_matmul_cuda: a_t and digits must be contiguous")
    dev = a_t.device
    if digits.device != dev:
        raise ValueError("cim_matmul_cuda: operands on different devices")
    s_p = s_p.to(device=dev, dtype=torch.float32).contiguous()
    deq = deq.to(device=dev, dtype=torch.float32).contiguous()
    if occ is not None:
        occ = occ.to(device=dev, dtype=torch.uint8).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    lib = _build.load("cim_matmul")
    with torch.cuda.device(dev):
        rc = lib.cim_matmul_launch(
            a_t.data_ptr(), digits.data_ptr(),
            occ.data_ptr() if occ is not None else None,
            s_p.data_ptr(), deq.data_ptr(), out.data_ptr(),
            m, k_tiles, rows, n_split, n, nibble_groups,
            int(a_t.dtype == torch.uint8), int(nibble), psum_bits,
            int(psum_quant), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cim_matmul kernel launch failed: "
                           f"{lib.cim_matmul_error_string(rc).decode()}")
    cim_matmul_cuda.launches += 1
    return out


cim_matmul_cuda.launches = 0
