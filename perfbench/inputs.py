"""The one input generator of every cell: weights, images, labels and
cell-variation fields, drawn from ``--seed`` on the device in a few large
calls. Each kind of input has its own stream (a generator seeded from a
hash of the seed and the stream's name), so a cell that draws more of
one kind leaves the others unchanged. The same seed on the same device
gives the same inputs.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import torch

from . import counts


def stream(seed: int, name: str, device) -> torch.Generator:
    tag = f"{int(seed)}/{name}".encode()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(hashlib.sha256(tag).digest()[:8], "little")
                  & (2 ** 63 - 1))
    return g


def _split(flat: torch.Tensor, shapes: List[tuple]) -> List[torch.Tensor]:
    sizes = [math.prod(s) for s in shapes]
    return [t.reshape(s) for t, s in zip(torch.split(flat, sizes), shapes)]


def raw_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every conv weight (HWIO, He init: N(0, 2 / fan_in)) and the FC
    weight (N(0, 1 / C)) and bias (0), float32, from one normal draw."""
    plan = counts.conv_plan(config)
    c_last, n_cls = config["stage_widths"][-1], config["n_classes"]
    shapes = [(c.kh, c.kw, c.c_in, c.c_out) for c in plan] + [(c_last, n_cls)]
    flat = torch.randn(sum(math.prod(s) for s in shapes), device=device,
                       generator=stream(seed, "weights", device))
    parts = _split(flat, shapes)
    out = {c.name: p * math.sqrt(2.0 / (c.kh * c.kw * c.c_in))
           for c, p in zip(plan, parts)}
    out["fc.w"] = parts[-1] / math.sqrt(c_last)
    out["fc.b"] = torch.zeros(n_cls, device=device)
    return out


def images(config: dict, seed: int, n: int, name: str, device):
    """(x (n, H, W, C) float32, labels (n,) int64): class-conditional
    images, each its class's mean image (shared by every stream of the
    seed) plus unit normal noise."""
    hw, c, n_cls = config["in_hw"], config["in_channels"], config["n_classes"]
    means = torch.randn((n_cls, hw, hw, c), device=device,
                        generator=stream(seed, "class_means", device))
    g = stream(seed, name, device)
    labels = torch.randint(0, n_cls, (n,), device=device, generator=g)
    noise = torch.randn((n, hw, hw, c), device=device, generator=g)
    return means[labels] + noise, labels


def thetas(config: dict, seed: int, n_sets: int, device
           ) -> List[Dict[str, torch.Tensor]]:
    """``n_sets`` cell-variation realizations: per CIM conv a standard
    normal float32 field over its logical packed (S, k_tiles, kh, kw,
    c_per_array, C_out) planes, as ``{layer name: theta}``."""
    convs = counts.cim_convs(config)
    shapes = [counts.plane_shape(c, config["cim"]) for c in convs]
    per_set = sum(math.prod(s) for s in shapes)
    flat = torch.randn(n_sets * per_set, device=device,
                       generator=stream(seed, "theta", device))
    return [dict(zip((c.name for c in convs), _split(part, shapes)))
            for part in torch.split(flat, per_set)]
