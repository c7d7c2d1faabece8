"""ResNet-20 (CIFAR) / ResNet-18 on the CIM convolution framework
(counterpart of ``repro.models.resnet``), the paper's evaluation models.

Every conv but the stem goes through the CIM conv forward
(``repro_torch.api.conv2d``); the stem conv and the final FC stay full
precision. Parameters and BatchNorm running statistics are two plain
dicts laid out like the reference's trees, activations are NHWC. The
forward writes nothing in place, so ``train=True`` on the emulate backend
is differentiable with respect to the params (``repro_torch.train.qat``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch import resolve_device, to_device
from repro_torch.core.cim_conv import _calibrate_conv, _conv_forward, _init_conv
from repro_torch.core.cim_linear import CIMConfig, _deprecated


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    depth: int                    # 20 (cifar) or 18 (imagenet-style)
    n_classes: int
    widths: Tuple[int, ...] = (16, 32, 64)
    in_hw: int = 32
    cim: CIMConfig = dataclasses.field(default_factory=CIMConfig)
    bn_momentum: float = 0.9

    @property
    def blocks_per_stage(self) -> int:
        return 3 if self.depth == 20 else 2

    @property
    def stage_widths(self) -> Tuple[int, ...]:
        return self.widths if self.depth == 20 else (64, 128, 256, 512)


def _bn_init(c: int, device):
    return ({"scale": torch.ones(c, device=device),
             "bias": torch.zeros(c, device=device)},
            {"mean": torch.zeros(c, device=device),
             "var": torch.ones(c, device=device)})


def _bn_apply(p, s, x, train: bool, momentum: float):
    xf = x.to(torch.float32)
    if train:
        mu = xf.mean(dim=(0, 1, 2))
        var = xf.var(dim=(0, 1, 2), correction=0)   # population, as jnp.var
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mu,
                 "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mu, var, new_s = s["mean"], s["var"], s
    y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y.to(x.dtype), new_s


def _blocks(cfg: ResNetConfig):
    """(block name, stage width, stride, has projection) in forward order."""
    widths = cfg.stage_widths
    c_in = widths[0]
    for si, w in enumerate(widths):
        for bi in range(cfg.blocks_per_stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            yield f"s{si}b{bi}", w, stride, (stride != 1 or c_in != w)
            c_in = w


def init(gen: torch.Generator | int, cfg: ResNetConfig, *, device=None):
    """(params, bn_state) on ``device`` (``cuda`` unless ``"cpu"``). Weights
    are drawn on the CPU from ``gen`` (a generator or an int seed), so a
    seed gives the same model on every device."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    widths = cfg.stage_widths
    fp = cfg.cim.replace(enabled=False)
    params: Dict = {"stem": _init_conv(gen, 3, 3, 3, widths[0], fp, device=dev)}
    state: Dict = {}
    params["stem_bn"], state["stem_bn"] = _bn_init(widths[0], dev)
    c_in = widths[0]
    for name, w, _, proj in _blocks(cfg):
        blk: Dict = {
            "conv1": _init_conv(gen, 3, 3, c_in, w, cfg.cim, device=dev),
            "conv2": _init_conv(gen, 3, 3, w, w, cfg.cim, device=dev),
        }
        bst: Dict = {}
        blk["bn1"], bst["bn1"] = _bn_init(w, dev)
        blk["bn2"], bst["bn2"] = _bn_init(w, dev)
        if proj:
            blk["proj"] = _init_conv(gen, 1, 1, c_in, w, cfg.cim, device=dev)
            blk["bn_p"], bst["bn_p"] = _bn_init(w, dev)
        params[name], state[name] = blk, bst
        c_in = w
    fc_w = torch.randn((c_in, cfg.n_classes), generator=gen) / c_in ** 0.5
    params["fc"] = {"w": fc_w.to(dev),
                    "b": torch.zeros(cfg.n_classes, device=dev)}
    return params, state


def pack_deploy(params: Dict, cfg: ResNetConfig, *, device=None) -> Dict:
    """Deprecated: use ``repro_torch.api.pack_model(params, cfg.cim)`` (or
    ``repro_torch.api.model_artifact`` for a saveable ``DeployArtifact``).
    Packs every CIM conv; the stem, BN and FC pass through."""
    _deprecated("models.resnet.pack_deploy", "repro_torch.api.pack_model")
    from repro_torch.api import pack_model
    return pack_model(params, cfg.cim, device=device)


def conv_layer_names(cfg: ResNetConfig) -> Tuple[Tuple[str, int], ...]:
    """Ordered (layer name, stride) of every CIM conv in forward order:
    "s0b0.conv1", "s0b0.conv2", ..., "s1b0.proj", ..."""
    out = []
    for name, _, stride, proj in _blocks(cfg):
        out += [(f"{name}.conv1", stride), (f"{name}.conv2", 1)]
        if proj:
            out.append((f"{name}.proj", stride))
    return tuple(out)


def layer_variation(variation, name: str):
    """The variation of the CIM conv ``name``: its own sampler or drift
    source (``for_layer``), its entry of a {layer name: theta} dict, or
    None."""
    if variation is None:
        return None
    if hasattr(variation, "for_layer"):       # a Sampler or a drift source
        return variation.for_layer(name)
    return variation.get(name)


def forward(params: Dict, state: Dict, x, cfg: ResNetConfig, *, train: bool,
            variation=None, variation_std=None, return_taps: bool = False,
            device=None):
    """x (B, H, W, 3) -> (logits, new_bn_state) on ``device`` (``cuda``
    unless ``"cpu"``). ``params`` may be trainable or packed
    (``api.pack_model``), as ``cfg.cim.mode`` requires. With
    ``return_taps=True`` also returns {layer name: conv input}.

    ``variation`` evaluates one cell-noise realization: a ``Sampler`` or
    a drift source (each CIM conv draws its own field, ``for_layer``) or
    a dict {layer name: theta over that layer's 6-D logical packed
    shape}, keyed by ``conv_layer_names`` (the counterpart of the
    reference's ``variation_keys``). Sigma is ``variation_std`` (a
    ``DriftState`` for drift), else ``cfg.cim.variation_std``."""
    dev = resolve_device(device)
    params, state = to_device(params, dev), to_device(state, dev)
    x = torch.as_tensor(x, device=dev)
    new_state: Dict = {}
    taps: Dict[str, torch.Tensor] = {}
    fp = cfg.cim.replace(enabled=False)

    def cim_conv(inp, block, layer, stride=1):
        return _conv_forward(inp, params[block][layer], cfg.cim,
                             stride=stride,
                             variation=layer_variation(variation,
                                                       f"{block}.{layer}"),
                             variation_std=variation_std,
                             compute_dtype=torch.float32)

    h = _conv_forward(x, params["stem"], fp, compute_dtype=torch.float32)
    h, new_state["stem_bn"] = _bn_apply(params["stem_bn"], state["stem_bn"],
                                        h, train, cfg.bn_momentum)
    h = torch.relu(h)
    for name, _, stride, _ in _blocks(cfg):
        blk, bst = params[name], state[name]
        nst: Dict = {}
        if return_taps:
            taps[f"{name}.conv1"] = h
        y = cim_conv(h, name, "conv1", stride)
        y, nst["bn1"] = _bn_apply(blk["bn1"], bst["bn1"], y, train,
                                  cfg.bn_momentum)
        y = torch.relu(y)
        if return_taps:
            taps[f"{name}.conv2"] = y
        y = cim_conv(y, name, "conv2")
        y, nst["bn2"] = _bn_apply(blk["bn2"], bst["bn2"], y, train,
                                  cfg.bn_momentum)
        if "proj" in blk:
            if return_taps:
                taps[f"{name}.proj"] = h
            sc = cim_conv(h, name, "proj", stride)
            sc, nst["bn_p"] = _bn_apply(blk["bn_p"], bst["bn_p"], sc, train,
                                        cfg.bn_momentum)
        else:
            sc = h
        h = torch.relu(y + sc)
        new_state[name] = nst
    h = h.mean(dim=(1, 2))
    logits = h @ params["fc"]["w"] + params["fc"]["b"]
    if return_taps:
        return logits, new_state, taps
    return logits, new_state


def calibrate(params: Dict, state: Dict, x, cfg: ResNetConfig, *,
              device=None) -> Dict:
    """One forward pass (train-mode BN) that calibrates every CIM conv's
    s_a / s_p from the activations that reach it. Returns new params."""
    dev = resolve_device(device)
    p = to_device(params, dev)
    state = to_device(state, dev)
    x = torch.as_tensor(x, device=dev)
    fp = cfg.cim.replace(enabled=False)
    h = _conv_forward(x, p["stem"], fp, compute_dtype=torch.float32)
    h, _ = _bn_apply(p["stem_bn"], state["stem_bn"], h, True, cfg.bn_momentum)
    h = torch.relu(h)
    for name, _, stride, _ in _blocks(cfg):
        blk = dict(p[name])
        bst = state[name]
        blk["conv1"] = _calibrate_conv(h, blk["conv1"], cfg.cim, stride=stride)
        y = _conv_forward(h, blk["conv1"], cfg.cim, stride=stride,
                          compute_dtype=torch.float32)
        y, _ = _bn_apply(blk["bn1"], bst["bn1"], y, True, cfg.bn_momentum)
        y = torch.relu(y)
        blk["conv2"] = _calibrate_conv(y, blk["conv2"], cfg.cim)
        y = _conv_forward(y, blk["conv2"], cfg.cim, compute_dtype=torch.float32)
        y, _ = _bn_apply(blk["bn2"], bst["bn2"], y, True, cfg.bn_momentum)
        if "proj" in blk:
            blk["proj"] = _calibrate_conv(h, blk["proj"], cfg.cim,
                                          stride=stride)
            sc = _conv_forward(h, blk["proj"], cfg.cim, stride=stride,
                               compute_dtype=torch.float32)
            sc, _ = _bn_apply(blk["bn_p"], bst["bn_p"], sc, True,
                              cfg.bn_momentum)
        else:
            sc = h
        h = torch.relu(y + sc)
        p[name] = blk
    return p
