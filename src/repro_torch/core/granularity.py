"""Quantization granularity accounting for CIM arrays (counterpart of
``repro.core.granularity``).

A weight matrix W (K, N) is tiled onto CIM arrays of ``array_rows`` x
``array_cols`` cells. A b-bit weight occupies ``n_split = ceil(b / c)``
physical columns, so an array holds ``oc_per_array = array_cols //
n_split`` output channels. Weight scales are indexed (k_tile, col),
partial-sum scales (split, k_tile, col); parameter shapes collapse the
shared axes and ``broadcast_*`` expands them back.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import torch


class Granularity(str, enum.Enum):
    LAYER = "layer"
    ARRAY = "array"
    COLUMN = "column"


def n_splits(weight_bits: int, cell_bits: int) -> int:
    return int(math.ceil(weight_bits / cell_bits))


@dataclasses.dataclass(frozen=True)
class ArrayTiling:
    """Static tiling of a (K, N) weight matrix onto CIM arrays."""

    k: int
    n: int
    array_rows: int
    array_cols: int
    weight_bits: int
    cell_bits: int

    @property
    def n_split(self) -> int:
        return n_splits(self.weight_bits, self.cell_bits)

    @property
    def k_tiles(self) -> int:
        return int(math.ceil(self.k / self.array_rows))

    @property
    def k_padded(self) -> int:
        return self.k_tiles * self.array_rows

    @property
    def oc_per_array(self) -> int:
        return max(1, self.array_cols // self.n_split)

    @property
    def n_tiles(self) -> int:
        return int(math.ceil(self.n / self.oc_per_array))

    @property
    def n_arrays(self) -> int:
        return self.k_tiles * self.n_tiles

    def weight_scale_shape(self, g: Granularity) -> Tuple[int, ...]:
        if g == Granularity.LAYER:
            return (1, 1)
        if g == Granularity.ARRAY:
            return (self.k_tiles, self.n_tiles)
        return (self.k_tiles, self.n)

    def psum_scale_shape(self, g: Granularity) -> Tuple[int, ...]:
        if g == Granularity.LAYER:
            return (self.n_split, 1, 1)
        if g == Granularity.ARRAY:
            return (self.n_split, self.k_tiles, self.n_tiles)
        return (self.n_split, self.k_tiles, self.n)

    def broadcast_weight_scale(self, s: torch.Tensor) -> torch.Tensor:
        """Expand a weight-scale parameter to shape (k_tiles, N)."""
        if tuple(s.shape) == (1, 1):
            return torch.broadcast_to(s, (self.k_tiles, self.n))
        if tuple(s.shape) == (self.k_tiles, self.n_tiles):
            rep = torch.repeat_interleave(s, self.oc_per_array, dim=1)
            return rep[:, : self.n]
        if tuple(s.shape) != (self.k_tiles, self.n):
            raise ValueError(f"weight scale shape {tuple(s.shape)} does not "
                             f"fit tiling {(self.k_tiles, self.n)}")
        return s

    def broadcast_psum_scale(self, s: torch.Tensor) -> torch.Tensor:
        """Expand a psum-scale parameter to shape (n_split, k_tiles, N)."""
        if tuple(s.shape) == (self.n_split, 1, 1):
            return torch.broadcast_to(s, (self.n_split, self.k_tiles, self.n))
        if tuple(s.shape) == (self.n_split, self.k_tiles, self.n_tiles):
            rep = torch.repeat_interleave(s, self.oc_per_array, dim=2)
            return rep[:, :, : self.n]
        if tuple(s.shape) != (self.n_split, self.k_tiles, self.n):
            raise ValueError(f"psum scale shape {tuple(s.shape)} does not fit "
                             f"tiling {(self.n_split, self.k_tiles, self.n)}")
        return s

    def weight_group_size(self, g: Granularity) -> int:
        if g == Granularity.LAYER:
            return self.k * self.n
        if g == Granularity.ARRAY:
            return self.array_rows * self.oc_per_array
        return self.array_rows

    def dequant_muls(self, weight_g: Granularity, psum_g: Granularity) -> int:
        """Scale multiplications needed to dequantize one layer's outputs
        (paper Fig. 4 accounting)."""
        order = {Granularity.LAYER: 0, Granularity.ARRAY: 1,
                 Granularity.COLUMN: 2}
        finest = weight_g if order[weight_g] >= order[psum_g] else psum_g
        if finest == Granularity.LAYER:
            return 1
        if finest == Granularity.ARRAY:
            return self.n_arrays * self.oc_per_array
        return self.n_split * self.n_arrays * self.oc_per_array


def conv_tiling(kh: int, kw: int, c_in: int, c_out: int, array_rows: int,
                array_cols: int, weight_bits: int, cell_bits: int
                ) -> Tuple[ArrayTiling, int]:
    """Tiling of a conv layer under the paper's stretched-kernel rule: an
    array holds ``c_per_array = floor(rows / (kh*kw))`` whole input
    channels with all their taps. Returns (tiling with array_rows snapped
    to the used rows, c_per_array)."""
    taps = kh * kw
    c_per_array = max(1, array_rows // taps)
    used_rows = c_per_array * taps
    k_tiles = int(math.ceil(c_in / c_per_array))
    tiling = ArrayTiling(k=k_tiles * used_rows, n=c_out, array_rows=used_rows,
                         array_cols=array_cols, weight_bits=weight_bits,
                         cell_bits=cell_bits)
    return tiling, c_per_array
