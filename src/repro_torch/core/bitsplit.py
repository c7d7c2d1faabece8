"""Bit-splitting of integer weights across multi-bit memory cells
(counterpart of ``repro.core.bitsplit``).

Differential sign-magnitude: w_int = sign(w) * sum_s d_s * 2^(c*s) with
d_s the s-th base-2^c digit of |w_int|; the digit seen by the MAC is
sign(w) * d_s. The gradient with respect to w_int is straight through,
spread over the digits by least norm, so ``recombine(grad) == grad``.
"""
from __future__ import annotations

import torch

from .granularity import n_splits


def split_digits(w_int: torch.Tensor, weight_bits: int,
                 cell_bits: int) -> torch.Tensor:
    """Signed-magnitude digits of integer-valued ``w_int`` (float dtype
    ok), shape (n_split,) + w_int.shape, digit s with place value
    2**(cell_bits*s). The incoming gradient of digit s reaches w_int times
    place_s / sum(place**2) (the reference's least-norm STE)."""
    if weight_bits == 1:
        return w_int[None]
    s_count = n_splits(weight_bits, cell_bits)
    base = 2 ** cell_bits
    w = w_int.detach()
    sign = torch.sign(w)
    # truncation toward zero, as the reference's astype(int32)
    mag = torch.abs(w).to(torch.int32)
    digits = [((mag // (base ** s)) % base).to(w_int.dtype) * sign
              for s in range(s_count)]
    out = torch.stack(digits, dim=0)
    places = place_values(weight_bits, cell_bits,
                          device=w_int.device).to(w_int.dtype)
    corr = w_int - w                       # zero-valued, carries the grad
    return out + corr[None] * (places / torch.sum(places ** 2)).reshape(
        (s_count,) + (1,) * w_int.ndim)


def place_values(weight_bits: int, cell_bits: int, device=None) -> torch.Tensor:
    """(n_split,) float32 place values 2**(cell_bits*s), made on ``device``
    itself (no host-to-device copy, so a forward that calls it can be
    captured in a CUDA graph)."""
    s_count = n_splits(weight_bits, cell_bits)
    shift = cell_bits * torch.arange(s_count, dtype=torch.int64, device=device)
    return torch.bitwise_left_shift(torch.ones_like(shift),
                                    shift).to(torch.float32)


def recombine(digits: torch.Tensor, weight_bits: int,
              cell_bits: int) -> torch.Tensor:
    places = place_values(weight_bits, cell_bits,
                          device=digits.device).to(digits.dtype)
    return torch.tensordot(places, digits, dims=([0], [0]))
