"""Shapes, operations and bytes of the ResNet cells, counted from a
configuration file alone (no port import): the yardstick of the
roofline and mfu metrics.

A conv's work is counted over real rows: the taps times the real input
channels of each array tile, never the tile's padding. A CIM conv does
its MACs once per bit split (S digit planes). Bytes are each input and
output of one launch counted once: activation codes, digit planes as
the kernel receives them, the per-column scales (and occupancy map of
integer planes), and the float32 output.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAK_INT8_OPS = 1979e12        # int8 tensor cores, the card's highest rate
PEAK_FP64_TENSOR = 67e12       # FP64 tensor cores
PEAK_HBM_BYTES = 3.35e12       # HBM3 bandwidth


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    kh: int
    kw: int
    c_in: int
    c_out: int
    stride: int
    h: int                     # input height and width
    w: int
    cim: bool

    @property
    def ho(self) -> int:
        return math.ceil(self.h / self.stride)

    @property
    def wo(self) -> int:
        return math.ceil(self.w / self.stride)

    @property
    def macs_per_image(self) -> int:
        return self.ho * self.wo * self.c_out * self.kh * self.kw * self.c_in


def n_splits(cim: dict) -> int:
    return math.ceil(cim["weight_bits"] / cim["cell_bits"])


def tiling(conv: Conv, cim: dict):
    """(k_tiles, c_per_array) under the stretched-kernel rule: an array
    of ``array_rows`` rows holds floor(rows / taps) whole channels."""
    cpa = max(1, cim["array_rows"] // (conv.kh * conv.kw))
    return math.ceil(conv.c_in / cpa), cpa


def blocks(config: dict):
    """(block name, width, stride, has projection) in forward order."""
    widths = config["stage_widths"]
    c_in = widths[0]
    for si, w in enumerate(widths):
        for bi in range(config["blocks_per_stage"]):
            stride = 2 if (bi == 0 and si > 0) else 1
            yield f"s{si}b{bi}", w, stride, (stride != 1 or c_in != w)
            c_in = w


def conv_plan(config: dict) -> List[Conv]:
    """Every conv of the model in forward order: the full-precision stem
    first, then each block's conv1, conv2 and projection (CIM convs)."""
    hw, widths = config["in_hw"], config["stage_widths"]
    out = [Conv("stem", 3, 3, config["in_channels"], widths[0], 1, hw, hw,
                False)]
    c_in = widths[0]
    for name, w, stride, proj in blocks(config):
        out.append(Conv(f"{name}.conv1", 3, 3, c_in, w, stride, hw, hw, True))
        ho = math.ceil(hw / stride)
        out.append(Conv(f"{name}.conv2", 3, 3, w, w, 1, ho, ho, True))
        if proj:
            out.append(Conv(f"{name}.proj", 1, 1, c_in, w, stride, hw, hw,
                            True))
        c_in, hw = w, ho
    return out


def cim_convs(config: dict) -> List[Conv]:
    return [c for c in conv_plan(config) if c.cim]


def plane_shape(conv: Conv, cim: dict):
    """The logical packed (S, k_tiles, kh, kw, c_per_array, C_out) shape,
    over which cell variation's theta is drawn."""
    kt, cpa = tiling(conv, cim)
    return (n_splits(cim), kt, conv.kh, conv.kw, cpa, conv.c_out)


def model_ops_per_image(config: dict) -> int:
    """The forward's operations per image: 2 * S * MACs of every CIM
    conv, 2 * MACs of the stem and of the FC."""
    s = n_splits(config["cim"])
    ops = 0
    for c in conv_plan(config):
        ops += 2 * c.macs_per_image * (s if c.cim else 1)
    return ops + 2 * config["stage_widths"][-1] * config["n_classes"]


def conv_launch_cost(conv: Conv, cim: dict, batch: int, *,
                     float_planes: bool):
    """(operations, bytes) of one CIM conv launch at ``batch``: integer
    planes are int8 with an occupancy map, float planes (cell variation)
    float32 without one."""
    s = n_splits(cim)
    kt, cpa = tiling(conv, cim)
    ops = 2 * s * batch * conv.macs_per_image
    cols = s * kt * conv.c_out
    plane_cells = cols * conv.kh * conv.kw * cpa
    nbytes = (batch * conv.h * conv.w * conv.c_in              # codes
              + plane_cells * (4 if float_planes else 1)       # planes
              + cols * 4 * 2                                   # s_p, deq
              + (0 if float_planes else cols)                  # occupancy
              + batch * conv.ho * conv.wo * conv.c_out * 4)    # output
    return ops, nbytes


def k3_bound_s(config: dict, batch: int, *, float_planes: bool) -> float:
    """The least time one forward's CIM conv launches can take: per
    launch the larger of operations over the peak rate (int8, or FP64
    tensor cores for float planes) and bytes over HBM bandwidth,
    summed."""
    peak = PEAK_FP64_TENSOR if float_planes else PEAK_INT8_OPS
    total = 0.0
    for c in cim_convs(config):
        ops, nbytes = conv_launch_cost(c, config["cim"], batch,
                                       float_planes=float_planes)
        total += max(ops / peak, nbytes / PEAK_HBM_BYTES)
    return total
