"""Fused CIM matmul with partial-sum (ADC) quantization: the wrappers of
the hand-written Hopper kernel ``csrc/cim_matmul.cu``, the port of
``repro/kernels/cim_matmul.py::cim_matmul_pallas`` (dense body, occupancy
skip and nibble decode in one kernel family) and of its MoE variant
``cim_matmul_experts_pallas`` (every expert of a bank in one launch), plus
the operand checks the ADC-free wrappers (``kernels/cim_adc_free.py``)
share.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version (``ref.cim_matmul_ref``, ``ref.cim_matmul_experts_ref``).
``cim_matmul_cuda.launches`` counts the kernel's launches,
``cim_matmul_cuda.float_launches`` those of them on float32
(cell-variation) digit planes; ``cim_matmul_experts_cuda.launches`` counts
the MoE launches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.nibble import unpack_nibbles

from . import _build, ref

#: digit-plane storage -> the kernel's ``digit_kind``
DIGIT_KINDS = {torch.int8: 0, torch.uint8: 1, torch.float32: 2}


def logical_digits(digits: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Nibble planes unpacked (``groups`` half-split blocks), others as
    they are: what the plain versions take."""
    if digits.dtype == torch.uint8:
        return unpack_nibbles(digits, groups=groups)
    return digits


@dataclasses.dataclass
class KernelOperands:
    """Checked operands of one launch of the CIM matmul kernel family."""

    a_t: torch.Tensor
    digits: torch.Tensor
    occ: torch.Tensor | None
    cols: dict            # name -> (S, k_tiles, N) float32 scales
    out: torch.Tensor
    m: int
    k_tiles: int
    rows: int
    n_split: int
    n: int
    kind: int
    experts: int = 1      # leading expert axis of an MoE bank, else 1

    def common_args(self, nibble_groups: int):
        """(m, kt, rows, S, n, groups, a_unsigned, digit_kind)"""
        return (self.m, self.k_tiles, self.rows, self.n_split, self.n,
                nibble_groups, int(self.a_t.dtype == torch.uint8), self.kind)


def kernel_operands(name: str, a_t: torch.Tensor, digits: torch.Tensor,
                    occ: torch.Tensor | None, *, experts: bool = False,
                    **cols) -> KernelOperands:
    """Check a CUDA launch's operands and raise on what the kernel does not
    take: device, dtypes, shapes and contiguity. ``cols`` are the (S,
    k_tiles, N) scale operands; they are made float32 and contiguous.
    ``experts=True``: every operand carries a leading expert axis E (an
    MoE bank), and so does the output."""
    if a_t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a_t.device}")
    if digits.dtype not in DIGIT_KINDS:
        raise TypeError(f"{name}: digit planes must be int8, nibble uint8 or "
                        f"float32 (cell variation), got {digits.dtype}")
    if a_t.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"{name}: activation codes must be int8 or uint8, "
                        f"got {a_t.dtype}")
    nibble = digits.dtype == torch.uint8
    lead = 1 if experts else 0
    if a_t.ndim != 3 + lead or digits.ndim != 4 + lead:
        raise ValueError(f"{name}: activations {tuple(a_t.shape)} and planes "
                         f"{tuple(digits.shape)} have the wrong rank")
    ex = tuple(a_t.shape[:lead])
    m, k_tiles, rows = a_t.shape[lead:]
    n_split, kt_d, rows_d, n = digits.shape[lead:]
    if (tuple(digits.shape[:lead]) != ex or kt_d != k_tiles
            or rows_d != (rows // 2 if nibble else rows)):
        raise ValueError(f"{name}: planes {tuple(digits.shape)} do not match "
                         f"activations {tuple(a_t.shape)}")
    shape = ex + (n_split, k_tiles, n)
    for nm, v in tuple(cols.items()) + ((("occ", occ),) if occ is not None
                                        else ()):
        if tuple(v.shape) != shape:
            raise ValueError(f"{name}: {nm} has shape {tuple(v.shape)}, "
                             f"expected {shape}")
    if not (a_t.is_contiguous() and digits.is_contiguous()):
        raise ValueError(f"{name}: a_t and digits must be contiguous")
    dev = a_t.device
    if digits.device != dev:
        raise ValueError(f"{name}: operands on different devices")
    cols = {k: v.to(device=dev, dtype=torch.float32).contiguous()
            for k, v in cols.items()}
    if occ is not None:
        occ = occ.to(device=dev, dtype=torch.uint8).contiguous()
    return KernelOperands(
        a_t=a_t, digits=digits, occ=occ, cols=cols,
        out=torch.empty(ex + (m, n), dtype=torch.float32, device=dev), m=m,
        k_tiles=k_tiles, rows=rows, n_split=n_split, n=n,
        kind=DIGIT_KINDS[digits.dtype], experts=ex[0] if ex else 1)


def raise_on_error(lib, rc: int, name: str,
                   error_string: str = "cim_matmul_error_string") -> None:
    """Raise with the CUDA error's text if a launch returned ``rc`` != 0;
    ``error_string`` names the library's function that gives the text."""
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def cim_matmul_cuda(a_t: torch.Tensor, digits: torch.Tensor,
                    s_p: torch.Tensor, deq: torch.Tensor,
                    occ: torch.Tensor | None = None, *, psum_bits: int,
                    psum_quant: bool = True,
                    nibble_groups: int = 1) -> torch.Tensor:
    """out (M, N) float32 = sum_t sum_s deq * ADC(a_t[:, t] @ digits[s, t]).

    a_t     (M, k_tiles, rows) int8 or uint8 activation codes
    digits  (S, k_tiles, rows, N) int8 or float32 (planes carrying cell
            variation), or nibble-packed uint8 (S, k_tiles, rows // 2, N)
            in ``nibble_groups`` half-split blocks
    s_p     (S, k_tiles, N) ADC scales
    deq     (S, k_tiles, N) fused dequant scales
    occ     optional (S, k_tiles, N) uint8 occupancy map of the planes
    """
    if a_t.device.type == "cpu":
        return ref.cim_matmul_ref(a_t, logical_digits(digits, nibble_groups),
                                  s_p, deq, psum_bits=psum_bits,
                                  psum_quant=psum_quant)
    op = kernel_operands("cim_matmul_cuda", a_t, digits, occ, s_p=s_p,
                         deq=deq)
    if op.m == 0:
        return op.out
    lib = _build.load("cim_matmul")
    with torch.cuda.device(a_t.device):
        rc = lib.cim_matmul_launch(
            a_t.data_ptr(), digits.data_ptr(),
            op.occ.data_ptr() if op.occ is not None else None,
            op.cols["s_p"].data_ptr(), op.cols["deq"].data_ptr(),
            op.out.data_ptr(), *op.common_args(nibble_groups), psum_bits,
            int(psum_quant), torch.cuda.current_stream(a_t.device).cuda_stream)
    raise_on_error(lib, rc, "cim_matmul")
    cim_matmul_cuda.launches += 1
    cim_matmul_cuda.float_launches += int(digits.dtype == torch.float32)
    return op.out


cim_matmul_cuda.launches = 0
cim_matmul_cuda.float_launches = 0


def cim_matmul_experts_cuda(a_t: torch.Tensor, digits: torch.Tensor,
                            s_p: torch.Tensor, deq: torch.Tensor,
                            occ: torch.Tensor | None = None, *,
                            psum_bits: int,
                            psum_quant: bool = True) -> torch.Tensor:
    """The CIM matmul of every expert of an MoE bank in one launch:
    out[e] = cim_matmul_cuda(a_t[e], digits[e], s_p[e], deq[e], occ[e]),
    bit for bit.

    a_t     (E, C, k_tiles, rows) int8 or uint8 activation codes
    digits  (E, S, k_tiles, rows, N) int8, or nibble-packed uint8 (E, S,
            k_tiles, rows // 2, N), read in place
    s_p     (E, S, k_tiles, N) ADC scales
    deq     (E, S, k_tiles, N) fused dequant scales
    occ     optional (E, S, k_tiles, N) uint8 occupancy maps

    Planes carrying cell variation (float32) are not taken, as in the
    reference: they go through ``cim_matmul_cuda`` one expert at a time.
    Returns (E, C, N) float32."""
    if digits.dtype == torch.float32:
        raise TypeError("cim_matmul_experts_cuda: float32 (cell-variation) "
                        "planes take the per-expert kernel")
    if a_t.device.type == "cpu":
        return ref.cim_matmul_experts_ref(a_t, logical_digits(digits), s_p,
                                          deq, psum_bits=psum_bits,
                                          psum_quant=psum_quant)
    op = kernel_operands("cim_matmul_experts_cuda", a_t, digits, occ,
                         experts=True, s_p=s_p, deq=deq)
    if op.m == 0 or op.experts == 0:
        return op.out
    lib = _build.load("cim_matmul")
    with torch.cuda.device(a_t.device):
        rc = lib.cim_matmul_experts_launch(
            a_t.data_ptr(), digits.data_ptr(),
            op.occ.data_ptr() if op.occ is not None else None,
            op.cols["s_p"].data_ptr(), op.cols["deq"].data_ptr(),
            op.out.data_ptr(), *op.common_args(1), psum_bits,
            int(psum_quant), op.experts,
            torch.cuda.current_stream(a_t.device).cuda_stream)
    raise_on_error(lib, rc, "cim_matmul_experts")
    cim_matmul_experts_cuda.launches += 1
    return op.out


cim_matmul_experts_cuda.launches = 0
