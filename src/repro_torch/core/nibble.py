"""Packed int4 nibble planes and per-(tile, column) plane occupancy
(counterpart of ``repro.core.nibble``).

torch has no usable int4 dtype, so the port stores *dense* int4 planes
as int8 holding [-8, 7] and *nibble-packed* planes as uint8. ``uint8`` is
the discriminator, as in the reference: a uint8 digit plane always means
nibble-packed. ``CIMConfig.store_dtype`` returns the string ``"int4"`` as
the int4 storage marker.

Half-split pairing along axis -2: packed row ``r`` carries digit row
``r`` in its low nibble and digit row ``r + rows/2`` in its high nibble,
both 4-bit two's complement. Only even row counts pack. The conv kernels
see the 6-D plane flattened to (S, kt, kh*kw*cpa_p, C_out), where each
of the kh*kw taps is its own packed block (``groups=kh*kw``).
"""
from __future__ import annotations

import torch

#: Storage dtype of nibble-packed digit planes, and their discriminator.
NIBBLE_DTYPE = torch.uint8
#: Marker ``CIMConfig.store_dtype`` returns for int4 storage.
INT4 = "int4"


def is_nibble_packed(planes: torch.Tensor) -> bool:
    return planes.dtype == NIBBLE_DTYPE


def can_pack_nibbles(rows: int, store_dtype) -> bool:
    """Nibble packing applies iff the storage grid is int4 and the packed
    (row) axis is even."""
    return store_dtype == INT4 and rows % 2 == 0


def stored_rows(rows: int, store_dtype):
    """(stored row count, storage dtype) of a digit plane's packed axis.
    Dense int4 is held as int8."""
    if can_pack_nibbles(rows, store_dtype):
        return rows // 2, NIBBLE_DTYPE
    return rows, (torch.int8 if store_dtype == INT4 else store_dtype)


def pack_nibbles(planes: torch.Tensor) -> torch.Tensor:
    """(..., rows, N) integer digits in [-8, 7], rows even ->
    (..., rows // 2, N) uint8 (half-split pairing)."""
    rows = planes.shape[-2]
    if rows % 2:
        raise ValueError(f"nibble packing needs an even packed axis, got "
                         f"{rows} (shape {tuple(planes.shape)})")
    x = planes.to(torch.int32)
    lo, hi = torch.split(x, rows // 2, dim=-2)
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(NIBBLE_DTYPE)


def unpack_nibbles(packed: torch.Tensor, *, groups: int = 1) -> torch.Tensor:
    """Invert ``pack_nibbles``: (..., rows_p, N) uint8 -> (..., 2*rows_p, N)
    int8. ``groups``: the packed axis holds that many independently packed
    blocks (kh*kw for the flattened conv view)."""
    rows_p = packed.shape[-2]
    if rows_p % groups:
        raise ValueError(f"packed axis {rows_p} not divisible by "
                         f"groups={groups}")
    x = packed.to(torch.int32)
    lo = ((x & 0xF) ^ 8) - 8
    hi = ((x >> 4) ^ 8) - 8
    lead = tuple(packed.shape[:-2])
    gh = rows_p // groups
    n = packed.shape[-1]
    lo = lo.reshape(lead + (groups, gh, n))
    hi = hi.reshape(lead + (groups, gh, n))
    out = torch.cat([lo, hi], dim=-2)
    return out.reshape(lead + (2 * rows_p, n)).to(torch.int8)


def occupancy_map(planes: torch.Tensor, *, conv: bool = False) -> torch.Tensor:
    """Per-(split, array tile, column) occupancy, uint8 {0, 1}, of logical
    (un-nibbled) planes: linear (..., S, kt, rows, N), or conv (..., S, kt,
    kh, kw, cpa, C_out) with ``conv=True``."""
    dims = (-4, -3, -2) if conv else (-2,)
    return (planes != 0).to(torch.uint8).amax(dim=dims)
