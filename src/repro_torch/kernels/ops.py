"""Single-device dispatch around the CIM kernels (counterpart of the
single-device branches of ``repro.kernels.ops``).

``use_kernel=True`` goes to the kernel wrappers, which launch the CUDA
kernel for a CUDA tensor (or raise) and run the plain version for a CPU
tensor. ``use_kernel=False`` runs the plain version (``kernels.ref``) on
whatever device the tensors are on. ``adc_free=True`` takes the ADC-free
kernels (no ADC, no s_p). Every conv, ADC or ADC-free, on integer or
float32 planes, gathers its patch rows inside the kernel (implicit GEMM,
``kernels.cim_conv.implicit_conv``); no patch tensor is made on the card.

Cell variation (``variation`` = a theta tensor or a ``Sampler``, with
``variation_std``) perturbs the planes here, before dispatch: nibble
planes are unpacked first (``groups = kh*kw`` for conv), the noise is
drawn over the logical packed layout (6-D for conv), and the kernel gets
float32 logical planes with the clean occupancy map, which multiplicative
noise leaves valid. A ``DriftState`` sigma with a drift source flows the
same way.

Observability (DESIGN.md §12): when the ``obs.adc`` collector is armed,
``cim_matmul`` and ``cim_conv`` (ADC on, not adc_free) add a per-column
ADC saturation side-output: the partial sums of the planes the kernel
multiplies are recomputed by a float32 einsum beside the kernel call
(the kernel never materializes them) and handed to ``obs.adc.record``.
The main output is untouched; a disarmed call, or an armed one the
collector's ``every_n`` will not fold, computes nothing extra. The conv's
side-output gathers its patches itself and counts them in
``_record_saturation.cuda_gathers``, apart from
``ref.extract_conv_patches.cuda_gathers``.

Column-parallel dispatch (DESIGN.md §10): with a ``mesh`` (a
``DeviceMesh``) of more than one rank along ``mesh_axis`` (``"model"``),
each rank runs the kernel on its own output columns and the one
collective is an all-gather of the (M, N/D) float32 outputs
(``core.colshard.gather_cols``), sliced back to N. Per-column ADC and
dequant scales are local to a column, so no partial sum crosses a rank.
A rank's operands are the local tensors of column-sharded leaves, or its
slice of full ones padded as ``pad_cols`` pads them (digit 0, psum scale
1, dequant 0, occupancy 0: dead columns, cut off after the gather;
``core.colshard.localize``). Cell variation and
drift are drawn over the full unpadded logical planes on every rank (the
same source gives every rank the same field) and each rank keeps its
columns, so the sharded output equals the single-device one bit for bit.
Armed, each rank records the saturation of its real columns;
``obs.adc``'s totals sum them over the mesh. The conv runs K3 (K5, the
float implicit GEMM) on each rank's C_out columns: the single-device
lowering, no patch gather in torch. A mesh of one rank is the
single-device path; column-sharded operands without a mesh raise.
"""
from __future__ import annotations

import torch

from repro_torch.core import colshard
from repro_torch.core.variation import (perturb_cols, perturb_digits,
                                        variation_wanted)
from repro_torch.obs import adc as obs_adc

from . import ref
from .cim_adc_free import cim_conv_adc_free_cuda, cim_matmul_adc_free_cuda
from .cim_conv import cim_conv_cuda
from .cim_matmul import (cim_matmul_cuda, cim_matmul_experts_cuda,
                         logical_digits)


def _record_saturation(a2: torch.Tensor, digits: torch.Tensor,
                       s_p: torch.Tensor, *, psum_bits: int) -> None:
    """ADC saturation side-output of a fused call (armed only): (M, kt,
    rows) codes against logical (S, kt, rows, N) planes, the planes the
    kernel multiplies (cell variation included). The caller has counted
    the call with ``obs_adc.will_fold()``."""
    psum = ref.einsum_f32("mtr,strn->mstn", a2.to(torch.float32),
                          digits.to(torch.float32))
    obs_adc.record(psum, s_p, psum_bits)


_record_saturation.cuda_gathers = 0

#: Mesh axis the packed column (output-channel) axis shards over: the
#: tensor-parallel axis of the serving meshes (``launch.serve --mesh``).
COL_SHARD_AXIS = "model"


def col_shards(mesh, mesh_axis: str = COL_SHARD_AXIS) -> int:
    """Number of column shards a mesh implies (1: the single-device
    dispatch)."""
    return colshard.mesh_shards(mesh, mesh_axis)


def pad_cols(digits, s_p, deq, n_shards: int, occ=None):
    """Pad the packed column axis to a multiple of ``n_shards``: dead
    columns get digit 0, psum scale 1, dequant scale 0 and occupancy 0,
    the kernel's own last-block rule, so they add nothing and are cut off
    after the gather. Nibble planes pad alike: the column axis is never
    the packed axis."""
    pad = (-digits.shape[-1]) % n_shards
    if not pad:
        return digits, s_p, deq, occ
    f = torch.nn.functional.pad
    return (f(digits, (0, pad)), f(s_p, (0, pad), value=1.0),
            f(deq, (0, pad)),
            None if occ is None else f(occ, (0, pad)))


def _check_unsharded(*xs) -> None:
    if any(colshard.is_col_sharded(x) for x in xs):
        raise RuntimeError("column-sharded planes need their session mesh: "
                           "install it (nn.module.set_activation_rules or "
                           "session_mesh) or serve through "
                           "engine_from_artifact(..., mesh=)")


def _sharded(run, record, digits, s_p, deq, occ, mesh, mesh_axis, *,
             variation, variation_std, groups: int = 1, noise_shape=None):
    """The column-parallel dispatch: this rank's columns of the operands
    (cell variation drawn over the full logical planes, then sliced),
    ``record(planes, s_p)`` of its real columns when the collector will
    fold this call, ``run(planes, s_p, deq, occ)`` on them, and the
    all-gather of the outputs."""
    n = digits.shape[-1]
    cols = colshard.col_range(mesh, mesh_axis, n)
    for x in (digits, s_p, deq, occ):
        if colshard.is_col_sharded(x) and (
                colshard.range_of(x).mesh != mesh
                or colshard.range_of(x).axis != mesh_axis):
            raise RuntimeError("column-sharded planes were placed on "
                               "another mesh than the session mesh")
    d = colshard.localize(digits, cols)
    if variation_wanted(variation, variation_std):
        d = perturb_cols(logical_digits(d, groups), cols, variation,
                         variation_std, shape=noise_shape)
    s_p = colshard.localize(s_p, cols, 1.0)
    deq = colshard.localize(deq, cols)
    occ = colshard.localize(occ, cols)
    if record is not None and obs_adc.will_fold():
        real = cols.real
        with obs_adc.partial_over((mesh_axis,)):
            record(logical_digits(d, groups)[..., :real], s_p[..., :real])
    return colshard.gather_cols(run(d, s_p, deq, occ), cols)


def cim_matmul(a_t: torch.Tensor, digits: torch.Tensor, s_p: torch.Tensor,
               deq: torch.Tensor, *, psum_bits: int, psum_quant: bool = True,
               use_kernel: bool = True, occ: torch.Tensor | None = None,
               variation=None, variation_std=None,
               adc_free: bool = False, mesh=None,
               mesh_axis: str = COL_SHARD_AXIS) -> torch.Tensor:
    """CIM matmul over pre-tiled inputs.

    a_t (..., k_tiles, rows) integer codes; digits (S, k_tiles, rows, N)
    int8, float32 or nibble uint8 (S, k_tiles, rows // 2, N); s_p, deq
    (S, k_tiles, N) (s_p is not read when ``adc_free``); occ optional
    (S, k_tiles, N) occupancy map (the plain version ignores it: the
    sparse kernel is bit-exact with the dense arithmetic). With ``mesh``
    of more than one rank along ``mesh_axis``: the column-parallel
    dispatch. Returns (..., N) float32."""
    batch_shape = tuple(a_t.shape[:-2])
    a2 = a_t.reshape((-1,) + tuple(a_t.shape[-2:]))
    if col_shards(mesh, mesh_axis) > 1:
        armed = obs_adc.enabled() and psum_quant and not adc_free
        out = _sharded(
            lambda d, sp, dq, oc: _matmul_local(
                a2, d, sp, dq, oc, psum_bits=psum_bits,
                psum_quant=psum_quant, use_kernel=use_kernel,
                adc_free=adc_free),
            (lambda d, sp: _record_saturation(a2, d, sp, psum_bits=psum_bits))
            if armed else None,
            digits, s_p, deq, occ, mesh, mesh_axis, variation=variation,
            variation_std=variation_std)
        return out.reshape(batch_shape + (digits.shape[-1],))
    _check_unsharded(digits, s_p, deq, occ)
    if variation_wanted(variation, variation_std):
        digits = perturb_digits(logical_digits(digits), variation,
                                variation_std)
    if (obs_adc.enabled() and psum_quant and not adc_free
            and obs_adc.will_fold()):
        _record_saturation(a2, logical_digits(digits), s_p,
                           psum_bits=psum_bits)
    out = _matmul_local(a2, digits, s_p, deq, occ, psum_bits=psum_bits,
                        psum_quant=psum_quant, use_kernel=use_kernel,
                        adc_free=adc_free)
    return out.reshape(batch_shape + (digits.shape[-1],))


def _matmul_local(a2, digits, s_p, deq, occ, *, psum_bits, psum_quant,
                  use_kernel, adc_free):
    """One device's matmul: the kernel, or its plain version."""
    if use_kernel and adc_free:
        return cim_matmul_adc_free_cuda(a2, digits, deq, occ)
    if use_kernel:
        return cim_matmul_cuda(a2, digits, s_p, deq, occ, psum_bits=psum_bits,
                               psum_quant=psum_quant)
    if adc_free:
        return ref.cim_matmul_adc_free_ref(a2, logical_digits(digits), deq)
    return ref.cim_matmul_ref(a2, logical_digits(digits), s_p, deq,
                              psum_bits=psum_bits, psum_quant=psum_quant)


def cim_matmul_experts(a_t: torch.Tensor, digits: torch.Tensor,
                       s_p: torch.Tensor, deq: torch.Tensor, *,
                       psum_bits: int, psum_quant: bool = True,
                       use_kernel: bool = True,
                       occ: torch.Tensor | None = None,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """MoE expert-bank dispatch: every expert's capacity buffer through one
    launch of the CIM experts kernel, bit-exact with ``cim_matmul`` once
    per expert on the buffers with their rows at or past ``counts``
    zeroed.

    a_t (E, C, k_tiles, rows) integer codes; digits (E, S, k_tiles, rows,
    N) int8 or nibble uint8 (E, S, k_tiles, rows // 2, N); s_p, deq (E, S,
    k_tiles, N); occ optional (E, S, k_tiles, N); counts optional (E,)
    int32, each expert's filled capacity slots (the kernel skips the
    rest). No cell variation, as in the reference. Returns (E, C, N)
    float32."""
    if use_kernel:
        return cim_matmul_experts_cuda(a_t, digits, s_p, deq, occ,
                                       psum_bits=psum_bits,
                                       psum_quant=psum_quant, counts=counts)
    return ref.cim_matmul_experts_ref(a_t, logical_digits(digits), s_p, deq,
                                      psum_bits=psum_bits,
                                      psum_quant=psum_quant, counts=counts)


def cim_conv(a_int: torch.Tensor, digits: torch.Tensor, s_p: torch.Tensor,
             deq: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
             padding="SAME", c_per_array: int, psum_bits: int,
             psum_quant: bool = True, use_kernel: bool = True,
             occ: torch.Tensor | None = None, variation=None,
             variation_std=None, adc_free: bool = False, mesh=None,
             mesh_axis: str = COL_SHARD_AXIS) -> torch.Tensor:
    """CIM conv over activation codes (B, H, W, C_in) and packed conv planes
    (S, k_tiles, kh*kw*c_per_array, C_out), int8 or float32, or their
    nibble form with each tap its own packed block. With ``mesh`` of more
    than one rank along ``mesh_axis``: the column-parallel dispatch over
    C_out. Returns (B, H', W', C_out) float32."""
    groups = kh * kw
    geo = dict(kh=kh, kw=kw, stride=stride, padding=padding,
               c_per_array=c_per_array)
    if col_shards(mesh, mesh_axis) > 1:
        n_split, k_tiles, _, c_out = digits.shape

        def record(d, sp):
            _record_saturation.cuda_gathers += int(a_int.is_cuda)
            p_t = ref.gather_conv_patches(a_int, kh, kw, stride, padding,
                                          k_tiles, c_per_array)
            _record_saturation(p_t.reshape(-1, k_tiles, p_t.shape[-1]), d,
                               sp, psum_bits=psum_bits)
        armed = obs_adc.enabled() and psum_quant and not adc_free
        return _sharded(
            lambda d, sp, dq, oc: _conv_local(
                a_int, d, sp, dq, oc, psum_bits=psum_bits,
                psum_quant=psum_quant, use_kernel=use_kernel,
                adc_free=adc_free, **geo),
            record if armed else None, digits, s_p, deq, occ, mesh,
            mesh_axis, variation=variation, variation_std=variation_std,
            groups=groups,
            noise_shape=(n_split, k_tiles, kh, kw, c_per_array, c_out))
    _check_unsharded(digits, s_p, deq, occ)
    if variation_wanted(variation, variation_std):
        n_split, k_tiles, _, c_out = digits.shape
        digits = perturb_digits(
            logical_digits(digits, groups), variation, variation_std,
            shape=(n_split, k_tiles, kh, kw, c_per_array, c_out))
    if (obs_adc.enabled() and psum_quant and not adc_free
            and obs_adc.will_fold()):
        k_tiles = digits.shape[1]
        _record_saturation.cuda_gathers += int(a_int.is_cuda)
        p_t = ref.gather_conv_patches(a_int, kh, kw, stride, padding,
                                      k_tiles, c_per_array)
        _record_saturation(p_t.reshape(-1, k_tiles, p_t.shape[-1]),
                           logical_digits(digits, groups), s_p,
                           psum_bits=psum_bits)
    return _conv_local(a_int, digits, s_p, deq, occ, psum_bits=psum_bits,
                       psum_quant=psum_quant, use_kernel=use_kernel,
                       adc_free=adc_free, **geo)


def _conv_local(a_int, digits, s_p, deq, occ, *, psum_bits, psum_quant,
                use_kernel, adc_free, **geo):
    """One device's conv: the implicit-GEMM kernel, or its plain version."""
    groups = geo["kh"] * geo["kw"]
    if use_kernel and adc_free:
        return cim_conv_adc_free_cuda(a_int, digits, deq, occ, **geo)
    if use_kernel:
        return cim_conv_cuda(a_int, digits, s_p, deq, occ, psum_bits=psum_bits,
                             psum_quant=psum_quant, **geo)
    if adc_free:
        return ref.cim_conv_adc_free_ref(a_int, logical_digits(digits, groups),
                                         deq, **geo)
    return ref.cim_conv_ref(a_int, logical_digits(digits, groups), s_p, deq,
                            psum_bits=psum_bits, psum_quant=psum_quant, **geo)
