"""Plain PyTorch reference of one-stage column-wise QAT (paper §III-A:
LSQ on weights, activations and partial sums at column granularity), the
training step the port's ``train/qat.py`` runs, written from the
configuration file alone.

Forward of a CIM conv in training (the emulate arithmetic):

  a     = round_ste(LSQ(x; s_a, [0, 2^b_a - 1]) / s_a)
  w_int = LSQ(w; s_w[tile, col], [-2^(b_w-1), 2^(b_w-1) - 1]) / s_w
  d_s   = the digits of w_int, straight through: dL/dw_int =
          sum_s dL/dd_s * 2^(c s) / sum_s 2^(2 c s)
  p     = round_ste(per-tile conv of a and d)
  q     = LSQ(p; s_p[s, tile, col], [-2^(b_p-1), 2^(b_p-1) - 1])
  y     = (sum over t, s of q * 2^(c s) * s_w) * s_a

LSQ (Esser et al. 2020): y = clip(round(x / s), q_n, q_p) s; dy/dx = 1
inside the range, 0 outside; dy/ds = round(x/s) - x/s inside, q_n or q_p
outside, times g = 1 / sqrt(n q_p), n the elements of one scale's group
(the array's rows for a weight column, every element for the
activation, the batch's positions for a partial-sum column).

The step: mean cross-entropy, every parameter (weights, LSQ scales, BN
affine) trained with m = 0.9 m + g, p = p - lr m; BN statistics updated
with momentum 0.9 from the batch's (population variance). Float32 with
TF32 off; ``tf32=True``, the control, rounds the stem's and the FC's
operands to TF32 (``resnet.tf32_round``).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .. import counts
from .resnet import (F32, Model, conv_nhwc, fc, no_tf32, planes_of, qrange,
                     same_pads)

MOMENTUM = 0.9


class _LSQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, qn, qp, g):
        s = torch.clamp_min(s, 1e-9)
        v = x / s
        q = torch.clamp(torch.round(v), qn, qp)
        ctx.save_for_backward(v, q)
        ctx.shape, ctx.qn, ctx.qp, ctx.g = s.shape, qn, qp, g
        return q * s

    @staticmethod
    def backward(ctx, dy):
        v, q = ctx.saved_tensors
        inside = (v > ctx.qn) & (v < ctx.qp)
        ds = dy * torch.where(inside, q - v, q) * ctx.g
        while ds.ndim > len(ctx.shape):
            ds = ds.sum(dim=0)
        dims = tuple(i for i, n in enumerate(ctx.shape) if n == 1
                     and ds.shape[i] != 1)
        if dims:
            ds = ds.sum(dim=dims, keepdim=True)
        return torch.where(inside, dy, 0.0), ds.reshape(ctx.shape), \
            None, None, None


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x) + 0.0

    @staticmethod
    def backward(ctx, dy):
        return dy


def grad_scale(n: int, qp: int) -> float:
    """g = 1 / sqrt(n q_p) in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(float(n)
                                                      * float(max(qp, 1)))))


def lsq(x, s, bits: int, signed: bool, n: int):
    qn, qp = qrange(bits, signed)
    return _LSQ.apply(x, s, float(qn), float(qp), grad_scale(n, qp))


def train_cim_conv(x, layer: Dict[str, torch.Tensor], stride: int,
                   cim: dict) -> torch.Tensor:
    w, s_w, s_p, s_a = layer["w"], layer["s_w"], layer["s_p"], layer["s_a"]
    kh, kw, c_in, c_out = w.shape
    cpa = max(1, cim["array_rows"] // (kh * kw))
    kt = math.ceil(c_in / cpa)
    n_split = counts.n_splits(cim)
    a = lsq(x, s_a, cim["act_bits"], cim["act_signed"], x.numel())
    a = _RoundSTE.apply(a / torch.clamp_min(s_a, 1e-9))
    s_full = torch.broadcast_to(
        s_w[torch.arange(c_in, device=w.device) // cpa][None, None], w.shape)
    w_int = (lsq(w, s_full, cim["weight_bits"], True, kh * kw * cpa)
             / torch.clamp_min(s_full, 1e-9))
    places = 2.0 ** (cim["cell_bits"] * torch.arange(n_split, device=w.device,
                                                     dtype=F32))
    d6 = planes_of(w_int.detach(), cim)
    # the digits' straight-through gradient, spread by least norm
    corr = (w_int - w_int.detach())[None] * (
        places / torch.sum(places ** 2)).reshape(n_split, 1, 1, 1, 1)
    corr = F.pad(corr, (0, 0, 0, kt * cpa - c_in)).reshape(
        n_split, kh, kw, kt, cpa, c_out).permute(0, 3, 1, 2, 4, 5)
    d6 = d6 + corr
    a = F.pad(a, (0, kt * cpa - c_in))
    top, bottom = same_pads(a.shape[1], kh, stride)
    left, right = same_pads(a.shape[2], kw, stride)
    xn = F.pad(a.permute(0, 3, 1, 2), (left, right, top, bottom))
    wg = d6.permute(1, 0, 5, 4, 2, 3).reshape(kt * n_split * c_out, cpa,
                                              kh, kw)
    p = F.conv2d(xn, wg, stride=stride, groups=kt)
    b, _, ho, wo = p.shape
    p = p.reshape(b, kt, n_split, c_out, ho, wo).permute(0, 4, 5, 2, 1, 3)
    p = _RoundSTE.apply(p)
    q = lsq(p, s_p, cim["psum_bits"], True, p.numel() // s_p.numel())
    deq = places[:, None, None] * s_w[None]
    out = torch.zeros(q.shape[:3] + (c_out,), dtype=F32, device=x.device)
    for t in range(kt):
        for s in range(n_split):
            out = out + q[..., s, t, :] * deq[s, t]
    return out * torch.clamp_min(s_a, 1e-9)


class Trainer:
    """The reference's QAT from raw weights: its own calibration on
    ``x_cal``, then momentum SGD steps. Parameters and BN statistics are
    kept under the port's tree paths ("s0b0.conv1.s_p", "s0b0.bn1.scale",
    "stem_bn.mean", ...) so that the two compare leaf by leaf."""

    def __init__(self, config: dict, raw: Dict[str, torch.Tensor],
                 x_cal: torch.Tensor, tf32: bool = False):
        self.config, self.cim, self.tf32 = config, config["cim"], tf32
        ref = Model(config, raw, tf32)
        with torch.no_grad(), no_tf32():
            ref.walk(x_cal, train=True, calibrate=True)
        p: Dict[str, torch.Tensor] = {"stem.w": raw["stem"]}
        for name, layer in ref.layers.items():
            for k in ("w", "s_w", "s_p", "s_a"):
                p[f"{name}.{k}"] = layer[k]
        self.bn_names = ["stem_bn"]
        for name, _, _, proj in counts.blocks(config):
            self.bn_names += [f"{name}.bn1", f"{name}.bn2"] + (
                [f"{name}.bn_p"] if proj else [])
        for bn, c in zip(self.bn_names, self._bn_widths()):
            p[f"{bn}.scale"] = torch.ones(c, device=x_cal.device)
            p[f"{bn}.bias"] = torch.zeros(c, device=x_cal.device)
        p["fc.w"], p["fc.b"] = raw["fc.w"], raw["fc.b"]
        self.params = {k: v.detach().clone() for k, v in p.items()}
        self.mom = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.state = {}
        for bn, c in zip(self.bn_names, self._bn_widths()):
            self.state[f"{bn}.mean"] = torch.zeros(c, device=x_cal.device)
            self.state[f"{bn}.var"] = torch.ones(c, device=x_cal.device)

    def _bn_widths(self) -> List[int]:
        out = [self.config["stage_widths"][0]]
        for _, w, _, proj in counts.blocks(self.config):
            out += [w, w] + ([w] if proj else [])
        return out

    def _bn(self, p, name, x, new_state):
        mu = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), correction=0)
        new_state[f"{name}.mean"] = (MOMENTUM * self.state[f"{name}.mean"]
                                     + (1 - MOMENTUM) * mu.detach())
        new_state[f"{name}.var"] = (MOMENTUM * self.state[f"{name}.var"]
                                    + (1 - MOMENTUM) * var.detach())
        return (x - mu) * torch.rsqrt(var + 1e-5) * p[f"{name}.scale"] \
            + p[f"{name}.bias"]

    def loss(self, p, x, y, new_state):
        cim = self.cim
        h = conv_nhwc(x, p["stem.w"], 1, tf32=self.tf32)
        h = torch.relu(self._bn(p, "stem_bn", h, new_state))
        for name, _, stride, proj in counts.blocks(self.config):
            def conv(inp, part, s):
                layer = {k: p[f"{name}.{part}.{k}"]
                         for k in ("w", "s_w", "s_p", "s_a")}
                return train_cim_conv(inp, layer, s, cim)
            z = torch.relu(self._bn(p, f"{name}.bn1",
                                    conv(h, "conv1", stride), new_state))
            z = self._bn(p, f"{name}.bn2", conv(z, "conv2", 1), new_state)
            sc = (self._bn(p, f"{name}.bn_p", conv(h, "proj", stride),
                           new_state) if proj else h)
            h = torch.relu(z + sc)
        logits = fc(h.mean(dim=(1, 2)), p["fc.w"], p["fc.b"], self.tf32)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.take_along_dim(logp, y[:, None], 1))

    def step(self, x, y, lr: float):
        """One step: (loss, gradients) before the update, which it applies."""
        with no_tf32():
            p = {k: v.detach().requires_grad_(True)
                 for k, v in self.params.items()}
            new_state: Dict[str, torch.Tensor] = {}
            loss = self.loss(p, x, y, new_state)
            names = list(p)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [p[k] for k in names])))
        lr32 = float(np.float32(lr))
        with torch.no_grad():
            for k in names:
                self.mom[k] = MOMENTUM * self.mom[k] + grads[k]
                self.params[k] = self.params[k] - lr32 * self.mom[k]
        self.state = new_state
        return loss.detach(), grads
