"""Learned Step Size Quantization (LSQ, Esser et al. 2020) at arbitrary
granularity (counterpart of ``repro.core.quantizer``), as the paper
extends it (§III-A) to column-wise scales for weights and partial sums.

Fake-quant returns float tensors on the integer grid times the learnable
scale. The gradients are the reference's ``custom_vjp``s, here
``torch.autograd.Function``s:

  dy/dx = 1                      inside the clip range, 0 outside
  dy/ds = round(x/s) - x/s       inside the clip range
        = q_n or q_p             outside
  with the scale gradient multiplied by g = 1/sqrt(N_group * q_p).

``bits == 1`` is binary sign quantization: y = sign(x) * s, with
sign(0) = +1 and a straight-through gradient inside |x| <= s.
``torch.round`` and ``jnp.round`` both round half to even, so codes agree
exactly with the reference.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_EPS = 1e-9


def qrange(bits: int, signed: bool = True) -> Tuple[int, int]:
    if bits == 1:
        return (-1, 1)
    if signed:
        return (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    return (0, 2 ** bits - 1)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round with a straight-through gradient: the value of the reference's
    ``x + stop_gradient(round(x) - x)``, which is round(x) with -0.0 made
    +0.0, in two passes instead of three."""
    return _RoundSTE.apply(x)


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x).add_(0.0)

    @staticmethod
    def backward(ctx, dy):
        return dy


def _reduce_to_shape(t: torch.Tensor, shape) -> torch.Tensor:
    """Sum a cotangent down to the shape of the operand it was broadcast
    from: leading extra axes, then the axes the operand holds at size 1."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    while t.ndim > len(shape):
        t = t.sum(dim=0)
    axes = tuple(i for i, (a, b) in enumerate(zip(t.shape, shape))
                 if b == 1 and a != 1)
    if axes:
        t = t.sum(dim=axes, keepdim=True)
    return t.reshape(shape)


class _LSQ(torch.autograd.Function):
    """clip(round(x / s), qn, qp) * s with the LSQ gradients. ``s`` is
    clamped to 1e-9 inside; its gradient is not masked by the clamp."""

    @staticmethod
    def forward(ctx, x, s, qn: float, qp: float, g: float):
        s = torch.clamp_min(s, _EPS)
        v = x / s
        q = torch.round(v).clamp_(qn, qp)
        ctx.save_for_backward(v, q, s)
        ctx.qn, ctx.qp, ctx.g = qn, qp, g
        return q * s

    @staticmethod
    def backward(ctx, dy):
        # outside the clip range the code q is q_n or q_p, inside round(v)
        v, q, s = ctx.saved_tensors
        mid = (v > ctx.qn) & (v < ctx.qp)
        dx = torch.where(mid, dy, 0.0)
        ds_elem = torch.where(mid, q - v, q)
        ds = _reduce_to_shape((dy * ds_elem).mul_(ctx.g), s.shape)
        return dx, ds, None, None, None


class _LSQBinary(torch.autograd.Function):
    """sign(x) * s (sign(0) = +1), straight through inside |x| <= s."""

    @staticmethod
    def forward(ctx, x, s, g: float):
        s = torch.clamp_min(s, _EPS)
        ctx.save_for_backward(x, s)
        ctx.g = g
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype) * s

    @staticmethod
    def backward(ctx, dy):
        x, s = ctx.saved_tensors
        dx = torch.where(torch.abs(x) <= s, dy, 0.0)
        sign = torch.where(x >= 0, 1.0, -1.0)
        return dx, _reduce_to_shape(dy * sign * ctx.g, s.shape), None


def _grad_scale(n: int, qp: int) -> float:
    """LSQ's g = 1 / sqrt(n * q_p), rounded as the reference computes it
    (a float32 square root and divide), held as a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(float(n)
                                                      * float(max(qp, 1)))))


def lsq_fake_quant(x: torch.Tensor, scale: torch.Tensor, bits: int, *,
                   signed: bool = True,
                   group_size: int | None = None) -> torch.Tensor:
    """Fake-quantize ``x`` with learnable ``scale`` (broadcastable to x).
    ``group_size`` is the element count of one scale's group, for the
    gradient scale g; it defaults to numel(x) // numel(scale), which for
    a partial sum counts the batch too."""
    qn, qp = qrange(bits, signed)
    n = (group_size if group_size is not None
         else max(1, x.numel() // max(1, scale.numel())))
    g = _grad_scale(n, qp)
    if bits == 1:
        return _LSQBinary.apply(x, scale, g)
    return _LSQ.apply(x, scale, float(qn), float(qp), g)


def lsq_integer(x: torch.Tensor, scale: torch.Tensor, bits: int, *,
                signed: bool = True,
                group_size: int | None = None) -> torch.Tensor:
    """The integer code (float dtype, integer valued) with LSQ gradients to
    ``x`` and ``scale``: ``lsq_fake_quant(x, s) / s``."""
    s = torch.clamp_min(scale, _EPS)
    return lsq_fake_quant(x, scale, bits, signed=signed,
                          group_size=group_size) / s


def init_scale_from(x: torch.Tensor, bits: int, axes, shape) -> torch.Tensor:
    """LSQ initialization: s = 2 * E|x| / sqrt(q_p), per group."""
    _, qp = qrange(bits, True)
    m = torch.mean(torch.abs(x), dim=axes)
    s = 2.0 * m / math.sqrt(float(max(qp, 1)))
    if s.ndim == 0:
        return torch.full(shape, float(s), dtype=torch.float32,
                          device=x.device) + _EPS
    return torch.broadcast_to(s.reshape(shape), shape).to(torch.float32) + _EPS
