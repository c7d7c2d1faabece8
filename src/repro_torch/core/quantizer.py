"""Learned Step Size Quantization (LSQ) forward, at arbitrary granularity
(counterpart of ``repro.core.quantizer``).

Fake-quant returns float tensors on the integer grid times the scale.
This slice ports the forward only; the LSQ gradient (the JAX
``custom_vjp``) arrives with the training slice as a
``torch.autograd.Function``. ``torch.round`` and ``jnp.round`` both round
half to even, so codes agree exactly with the reference.

``bits == 1`` is binary sign quantization: y = sign(x) * s, with
sign(0) = +1.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-9


def qrange(bits: int, signed: bool = True) -> Tuple[int, int]:
    if bits == 1:
        return (-1, 1)
    if signed:
        return (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    return (0, 2 ** bits - 1)


def lsq_fake_quant(x: torch.Tensor, scale: torch.Tensor, bits: int, *,
                   signed: bool = True) -> torch.Tensor:
    """Fake-quantize ``x`` with ``scale`` (broadcastable to x)."""
    s = torch.clamp_min(scale, _EPS)
    if bits == 1:
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype) * s
    qn, qp = qrange(bits, signed)
    return torch.clamp(torch.round(x / s), qn, qp) * s


def lsq_integer(x: torch.Tensor, scale: torch.Tensor, bits: int, *,
                signed: bool = True) -> torch.Tensor:
    """The integer code (float dtype, integer valued):
    ``lsq_fake_quant(x, s) / s``."""
    s = torch.clamp_min(scale, _EPS)
    return lsq_fake_quant(x, scale, bits, signed=signed) / s


def init_scale_from(x: torch.Tensor, bits: int, axes, shape) -> torch.Tensor:
    """LSQ initialization: s = 2 * E|x| / sqrt(q_p), per group."""
    _, qp = qrange(bits, True)
    m = torch.mean(torch.abs(x), dim=axes)
    s = 2.0 * m / math.sqrt(float(max(qp, 1)))
    if s.ndim == 0:
        return torch.full(shape, float(s), dtype=torch.float32,
                          device=x.device) + _EPS
    return torch.broadcast_to(s.reshape(shape), shape).to(torch.float32) + _EPS
