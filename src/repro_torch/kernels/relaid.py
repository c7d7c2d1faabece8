"""Kept relaid digit planes of the tensor-core kernels.

The int8 tensor-core kernels (``csrc/cim_mma.cuh``: the ADC matmul and
experts kernels of ``kernels/cim_matmul.py``, the ADC-free matmul and
implicit conv of ``kernels/cim_adc_free.py``) read their digit planes
relaid K-major (nibbles decoded) into a device workspace. The workspace is
kept per plane tensor (its base, offset, shape and dtype, and the call's
taps, segment and codes per row or pixel), beside the id of the layout it
holds, so constant planes are relaid once and later launches read the
relaid copy; the kernel relays them only when the id is not the layout it
needs. The ADC and ADC-free libraries compute the same ids, so a deploy
pack and an adc_free run on the same planes share one copy; an MoE bank
is relaid as one tensor, apart from its experts' slices. An in-place write
to the planes (their ``_version``) gives a new workspace, and the entry
goes with the planes' base tensor. The copy costs device memory about the
planes' int8 size (twice a nibble plane's); ``clear_relaid_planes()``
frees it. A launch inside a CUDA-graph capture uses what is kept and keeps
nothing new; ``check_capture`` raises if it relaid kept planes (run the
call once before capturing it). Later launches must be on the stream that
relaid the planes or ordered after it.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

#: {id(base tensor): {(offset, shape, dtype, geometry): [planes' _version,
#: workspace, layout id]}}
_KEPT: dict = {}


def relaid_planes(digits: torch.Tensor, nbytes: int, geometry: tuple):
    """(workspace, layout id, the id kept before or None) for a launch on
    ``digits`` whose call geometry is ``geometry`` (taps, segment, codes
    per row or pixel): the kept pair if the planes were not written since
    (the kernel relays them anyway if the id is not the layout it needs,
    and stores the new id), else a new workspace of ``nbytes`` with id 0,
    kept unless a CUDA graph is being captured."""
    base = digits if digits._base is None else digits._base
    key = (digits.storage_offset(), tuple(digits.shape), digits.dtype,
           tuple(geometry))
    kept = _KEPT.get(id(base), {}).get(key)
    if kept is not None and kept[0] == digits._version:
        return kept[1], kept[2], kept[2].value
    work = torch.empty(nbytes, dtype=torch.uint8, device=digits.device)
    layout = ctypes.c_longlong(0)
    if not torch.cuda.is_current_stream_capturing():
        if id(base) not in _KEPT:
            _KEPT[id(base)] = {}
            weakref.finalize(base, _KEPT.pop, id(base), None)
        _KEPT[id(base)][key] = [digits._version, work, layout]
    return work, layout, None


def check_capture(layout, kept_id, name: str) -> None:
    """Raise if a launch under CUDA-graph capture relaid kept planes: the
    relayout is only recorded, not run, so the kept copy no longer holds
    the layout its id names; it is dropped."""
    if (kept_id is not None and layout.value != kept_id
            and torch.cuda.is_current_stream_capturing()):
        clear_relaid_planes()
        raise RuntimeError(f"{name}: planes relaid in another layout during "
                           "a CUDA-graph capture; launch once on these "
                           "operands before capturing")


def clear_relaid_planes() -> None:
    """Free every kept relaid-plane workspace (the next launch on each
    plane relays it again)."""
    for per_base in _KEPT.values():
        per_base.clear()
