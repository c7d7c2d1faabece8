"""Plain PyTorch reference of the CIM ResNets (paper §III; ResNet-20/18,
arXiv:1512.03385), written from the configuration file alone.

It imports nothing of the port. From the raw weights and images it works
out again everything the port derives: the LSQ weight scales (column
granularity), the one-batch calibration of each CIM conv's activation
and partial-sum scales, the BatchNorm statistics, the digit planes, and
then the forward:

  activation codes  a = clip(round(x / s_a), 0, 2^b_a - 1)
  weight codes      w = clip(round(w / s_w), -2^(b_w-1), 2^(b_w-1) - 1)
  digits            sign(w) * (|w| // 2^(c s)) % 2^c, s < S
  partial sums      p[s, t, n] over the taps and real channels of array
                    tile t, exact (float64 MACs of integers)
  column-wise ADC   clip(round(round(p) / s_p), -2^(b_p-1), 2^(b_p-1) - 1)
  dequant           sum over t, then s, of ADC(p) * 2^(c s) * s_w[t, n],
                    in float32, times s_a

Cell variation multiplies each digit by exp(sigma * theta), theta over
the logical (S, k_tiles, kh, kw, c_per_array, C_out) planes; the float64
sums of such planes are exact (every product is, and the tile sums stay
under 2^53), so they too need no other arithmetic.

Float stages run in float32 with TF32 off. ``tf32=True`` gives the
control, the reference one precision lower: every float conv and matmul
(the stem, the FC; the CIM MACs are integers either way) takes its
operands rounded to TF32 (10 mantissa bits, to nearest even), as the
tensor cores do, with float32 sums; emulated the same on the CPU and the
card.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .. import counts

F32 = torch.float32


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits, to nearest even;
    the gradient passes straight through."""
    x = t.detach().contiguous()
    i = x.view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return t + (i.view(F32) - x)


def same_pads(size: int, k: int, stride: int):
    """XLA's "SAME": out = ceil(size / stride), the padding split with the
    smaller half first."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int,
              tf32: bool = False) -> torch.Tensor:
    """(B, H, W, C) x HWIO -> (B, H', W', C_out) float32, SAME padding;
    ``tf32``: the operands rounded to TF32 first."""
    if tf32:
        x, w = tf32_round(x), tf32_round(w)
    kh, kw = w.shape[:2]
    top, bottom = same_pads(x.shape[1], kh, stride)
    left, right = same_pads(x.shape[2], kw, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# one CIM conv
# ---------------------------------------------------------------------------

def qrange(bits: int, signed: bool):
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def weight_scale(w: torch.Tensor, cim: dict) -> torch.Tensor:
    """LSQ init of the column-wise weight scales, (k_tiles, C_out): 2 x the
    mean |w| of each column's real cells in its array / sqrt(q_p)."""
    if cim["weight_granularity"] != "column":
        raise ValueError("the reference knows column-wise weight scales only")
    kh, kw, c_in, c_out = w.shape
    cpa = max(1, cim["array_rows"] // (kh * kw))
    kt = math.ceil(c_in / cpa)
    w_abs = F.pad(w.abs(), (0, 0, 0, kt * cpa - c_in))
    ch = torch.clamp_max(c_in - torch.arange(kt, device=w.device) * cpa,
                         cpa).to(F32)
    m_col = (w_abs.reshape(kh * kw, kt, cpa, c_out).sum(dim=(0, 2))
             / (ch[:, None] * kh * kw))
    _, qp = qrange(cim["weight_bits"], True)
    return (2.0 * m_col / math.sqrt(float(max(qp, 1)))).to(F32) + 1e-9


def _fake_quant(x, s, qn, qp):
    s = torch.clamp_min(s, 1e-9)
    return torch.clamp(torch.round(x / s), qn, qp) * s


def weight_codes(w: torch.Tensor, s_w: torch.Tensor, cim: dict
                 ) -> torch.Tensor:
    """LSQ-quantized weights over their column scales, w_hat / s_w (float,
    within an ulp of the integer code)."""
    cpa = max(1, cim["array_rows"] // (w.shape[0] * w.shape[1]))
    qn, qp = qrange(cim["weight_bits"], True)
    s_full = torch.broadcast_to(
        s_w[torch.arange(w.shape[2], device=w.device) // cpa][None, None],
        w.shape)
    return _fake_quant(w, s_full, qn, qp) / torch.clamp_min(s_full, 1e-9)


def planes_of(w_int: torch.Tensor, cim: dict) -> torch.Tensor:
    """(S, k_tiles, kh, kw, c_per_array, C_out) float32 signed digits of
    the codes ``w_int`` (HWIO; magnitudes truncated toward zero), padded
    channels zero."""
    kh, kw, c_in, c_out = w_int.shape
    cpa = max(1, cim["array_rows"] // (kh * kw))
    kt = math.ceil(c_in / cpa)
    base, n_split = 2 ** cim["cell_bits"], counts.n_splits(cim)
    sign, mag = torch.sign(w_int), torch.abs(w_int).to(torch.int32)
    d = torch.stack([((mag // base ** s) % base).to(F32) * sign
                     for s in range(n_split)])
    d = F.pad(d, (0, 0, 0, kt * cpa - c_in))
    d = d.reshape(n_split, kh, kw, kt, cpa, c_out)
    return d.permute(0, 3, 1, 2, 4, 5).contiguous()


def digit_planes(w: torch.Tensor, s_w: torch.Tensor, cim: dict
                 ) -> torch.Tensor:
    return planes_of(weight_codes(w, s_w, cim), cim)


def act_codes(x: torch.Tensor, s_a: torch.Tensor, cim: dict) -> torch.Tensor:
    qn, qp = qrange(cim["act_bits"], cim["act_signed"])
    return torch.clamp(torch.round(x / torch.clamp_min(s_a, 1e-9)), qn, qp)


def partial_sums(a: torch.Tensor, d6: torch.Tensor, stride: int
                 ) -> torch.Tensor:
    """Per-(split, array tile) partial sums (B, H', W', S, kt, C_out)
    float32 of codes ``a`` (B, H, W, C_in) and planes ``d6``: one float64
    conv with a group per array tile over its channels, exact for the
    integer and the varied planes alike, rounded once."""
    n_split, kt, kh, kw, cpa, c_out = d6.shape
    a = F.pad(a, (0, kt * cpa - a.shape[-1]))
    top, bottom = same_pads(a.shape[1], kh, stride)
    left, right = same_pads(a.shape[2], kw, stride)
    xn = F.pad(a.permute(0, 3, 1, 2).to(torch.float64),
               (left, right, top, bottom))
    w = d6.permute(1, 0, 5, 4, 2, 3).reshape(kt * n_split * c_out, cpa,
                                             kh, kw)
    y = F.conv2d(xn, w.to(torch.float64), stride=stride,
                 groups=kt).to(F32)
    b, _, ho, wo = y.shape
    return y.reshape(b, kt, n_split, c_out, ho, wo).permute(0, 4, 5, 2, 1, 3)


def adc_dequant(p: torch.Tensor, s_p: torch.Tensor, s_w: torch.Tensor,
                cim: dict) -> torch.Tensor:
    """The column-wise ADC on each partial sum, then dequant and the
    shift-and-add: tile t outer, split s inner, float32 from 0."""
    qn, qp = qrange(cim["psum_bits"], True)
    q = _fake_quant(torch.round(p), s_p, qn, qp)
    n_split, kt = q.shape[-3], q.shape[-2]
    places = 2.0 ** (cim["cell_bits"] * torch.arange(n_split, device=p.device,
                                                     dtype=F32))
    deq = places[:, None, None] * s_w[None]
    out = torch.zeros(q.shape[:-3] + q.shape[-1:], dtype=F32, device=p.device)
    for t in range(kt):
        for s in range(n_split):
            out = out + q[..., s, t, :] * deq[s, t]
    return out


def calibrate_layer(x: torch.Tensor, layer: dict, stride: int,
                    cim: dict) -> None:
    """One-batch calibration: s_a = 2 E|x| / sqrt(q_p(a)), s_p per column =
    2 E|p| / sqrt(q_p(p)) over every output position of the batch."""
    _, qp_a = qrange(cim["act_bits"], cim["act_signed"])
    layer["s_a"] = (2.0 * torch.mean(torch.abs(x))
                    / math.sqrt(float(max(qp_a, 1)))).reshape(1) + 1e-9
    p = partial_sums(act_codes(x, layer["s_a"], cim), layer["d6"], stride)
    mean_abs = torch.mean(torch.abs(p.reshape((-1,) + p.shape[-3:])), dim=0)
    _, qp_p = qrange(cim["psum_bits"], True)
    layer["s_p"] = (2.0 * mean_abs / math.sqrt(float(max(qp_p, 1)))
                    ).to(F32) + 1e-9


def cim_conv(x: torch.Tensor, layer: dict, stride: int, cim: dict,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    d6 = layer["d6"] if noise is None else layer["d6"] * noise
    p = partial_sums(act_codes(x, layer["s_a"], cim), d6, stride)
    y = adc_dequant(p, layer["s_p"], layer["s_w"], cim)
    return y * torch.clamp_min(layer["s_a"], 1e-9)


def fc(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
       tf32: bool = False) -> torch.Tensor:
    if tf32:
        h, w = tf32_round(h), tf32_round(w)
    return h @ w + b


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Model:
    """The reference model of ``config`` from raw weights (``inputs.
    raw_weights``): CIM layers with their scales and planes, BN affine
    at (1, 0), BN statistics once ``calibrate`` has run."""

    def __init__(self, config: dict, raw: Dict[str, torch.Tensor],
                 tf32: bool = False):
        self.config, self.cim, self.tf32 = config, config["cim"], tf32
        self.raw = raw
        self.layers: Dict[str, dict] = {}
        for c in counts.cim_convs(config):
            w = raw[c.name]
            s_w = weight_scale(w, self.cim)
            self.layers[c.name] = {"w": w, "s_w": s_w,
                                   "d6": digit_planes(w, s_w, self.cim)}
        #: BN statistics (mean, var) by BN name; the affine is (1, 0)
        self.stats: Dict[str, tuple] = {}

    def _bn(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mu = x.mean(dim=(0, 1, 2))
            var = x.var(dim=(0, 1, 2), correction=0)
            self.stats[name] = (mu, var)
        else:
            mu, var = self.stats[name]
        return (x - mu) * torch.rsqrt(var + 1e-5)

    def walk(self, x: torch.Tensor, *, train: bool, calibrate: bool = False,
             noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The forward: train-mode BN records the batch's statistics;
        ``calibrate`` sets each CIM conv's scales from its input first."""
        cim = self.cim
        h = conv_nhwc(x, self.raw["stem"], 1, tf32=self.tf32)
        h = torch.relu(self._bn("stem_bn", h, train))
        for name, _, stride, proj in counts.blocks(self.config):
            def conv(inp, part, s):
                layer = self.layers[f"{name}.{part}"]
                if calibrate:
                    calibrate_layer(inp, layer, s, cim)
                return cim_conv(inp, layer, s, cim,
                                None if noise is None
                                else noise[f"{name}.{part}"])
            y = torch.relu(self._bn(f"{name}.bn1", conv(h, "conv1", stride),
                                    train))
            y = self._bn(f"{name}.bn2", conv(y, "conv2", 1), train)
            sc = (self._bn(f"{name}.bn_p", conv(h, "proj", stride), train)
                  if proj else h)
            h = torch.relu(y + sc)
        return fc(h.mean(dim=(1, 2)), self.raw["fc.w"], self.raw["fc.b"],
                  self.tf32)

    def calibrate(self, x: torch.Tensor) -> None:
        """The port's set-up for eval: calibrate the scales on ``x`` (train-
        mode BN), then BN statistics from one more train-mode forward of
        the calibrated model on ``x``."""
        self.walk(x, train=True, calibrate=True)
        self.walk(x, train=True)

    def logits(self, x: torch.Tensor, *, theta=None,
               sigma: float = 0.0) -> torch.Tensor:
        """Eval-mode logits (B, classes) float32 of the whole batch at once:
        a float32 conv's rounding depends on the algorithm cuDNN picks for
        its shape, and one ulp at the stem flips activation codes, so the
        reference runs the shapes the program ran. ``theta`` {layer: field}
        with ``sigma``: one variation realization."""
        noise = None
        if theta is not None:
            sig = torch.tensor(float(sigma), dtype=F32, device=x.device)
            noise = {k: torch.exp(sig * v) for k, v in theta.items()}
        return self.walk(x, train=False, noise=noise)


def eval_logits(config: dict, raw: Dict[str, torch.Tensor],
                x_cal: torch.Tensor, batches: List[dict], tf32: bool = False
                ) -> List[torch.Tensor]:
    """The reference's logits of each of ``batches`` ({"x", "theta",
    "sigma"}) after its own calibration on ``x_cal``."""
    with no_tf32(), torch.no_grad():
        model = Model(config, raw, tf32)
        model.calibrate(x_cal)
        return [model.logits(b["x"], theta=b.get("theta"),
                             sigma=b.get("sigma", 0.0)) for b in batches]
