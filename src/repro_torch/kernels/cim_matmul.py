"""Fused CIM matmul with partial-sum (ADC) quantization: the wrappers of
the hand-written Hopper kernels that port
``repro/kernels/cim_matmul.py::cim_matmul_pallas`` (dense body, occupancy
skip and nibble decode) and its MoE variant ``cim_matmul_experts_pallas``
(every expert of a bank in one launch), plus the operand checks the
ADC-free wrappers (``kernels/cim_adc_free.py``) share.

Dispatch on the planes' dtype, for CUDA tensors:
- integer planes (int8, or int4 nibble pairs in uint8) run the int8
  tensor-core kernels of ``csrc/cim_matmul_mma.cu``
  (``cim_matmul_mma_launch``; the experts kernel
  ``cim_matmul_experts_mma_launch``, which takes a bank's per-expert
  filled-slot ``counts`` and skips the empty slots). They read the planes
  relaid K-major into a workspace kept per plane tensor
  (``kernels/relaid.py``): a launch inside a CUDA-graph capture raises if
  it would relay kept planes (run the call once before capturing it);
- float32 planes (cell variation) run the FP64 tensor-core kernel of
  ``csrc/cim_matmul.cu`` (``cim_matmul_launch``), which first writes the
  planes as float64 into a workspace made per launch (they are drawn
  fresh for each Monte-Carlo sample); the experts kernel does not take
  them. The kernel equals its plain version bit for bit where each
  tile's float64 sum is exact in any order; ``check_float_exact`` shows
  that from the planes before a launch and raises where it cannot
  (``check_float_planes`` does it for a whole drift realization at once).
A refused launch raises. A CPU tensor runs the plain version
(``ref.cim_matmul_ref``, ``ref.cim_matmul_experts_ref``).

``cim_matmul_cuda.launches`` counts the matmul's launches,
``cim_matmul_cuda.float_launches`` those of them on float32 digit planes;
``cim_matmul_experts_cuda.launches`` counts the MoE launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from repro_torch.core.nibble import unpack_nibbles

from . import _build, ref
from .relaid import check_capture, relaid_planes

_MMA = "cim_matmul_mma"

#: digit-plane storages the kernels take
DIGIT_DTYPES = (torch.int8, torch.uint8, torch.float32)


def logical_digits(digits: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Nibble planes unpacked (``groups`` half-split blocks), others as
    they are: what the plain versions take."""
    if digits.dtype == torch.uint8:
        return unpack_nibbles(digits, groups=groups)
    return digits


@dataclasses.dataclass
class KernelOperands:
    """Checked operands of one launch of a CIM matmul kernel."""

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
    experts: int = 1      # leading expert axis of an MoE bank, else 1

    def shape_args(self):
        """(m, kt, rows, S, n)"""
        return self.m, self.k_tiles, self.rows, self.n_split, self.n

    @property
    def a_unsigned(self) -> int:
        return int(self.a_t.dtype == torch.uint8)

    @property
    def nibble(self) -> int:
        return int(self.digits.dtype == torch.uint8)


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
    if digits.dtype not in DIGIT_DTYPES:
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
        experts=ex[0] if ex else 1)


def raise_on_error(lib, rc: int, name: str,
                   error_string: str = "cim_matmul_error_string") -> None:
    """Raise with the CUDA error's text if a launch returned ``rc`` != 0;
    ``error_string`` names the library's function that gives the text."""
    if rc != 0:
        msg = getattr(lib, error_string)(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def float_workspace(lib, device, k_tiles: int, n_split: int, n: int,
                    taps: int, seg: int) -> torch.Tensor:
    """The float64 digit workspace of one launch of the FP64 kernels
    (``csrc/cim_matmul.cu``) on float32 planes: the matmul has taps 1 and
    segments of ``rows``, the conv kh*kw taps of ``c_per_array``."""
    return torch.empty(lib.cim_float_workspace(k_tiles, n_split, n, taps,
                                               seg),
                       dtype=torch.uint8, device=device)


#: bits of a float64 significand left over by a float32 digit's 24
EXACT_BITS = 53 - 24

#: planes shown exact: {id(base tensor): {key: planes' _version}}, the key
#: (offset, shape, codes unsigned) of a launch's view, or ("whole", codes
#: unsigned) of a whole packed node checked by ``check_float_planes``
_EXACT: dict = {}


def _lead(planes: torch.Tensor) -> int:
    """Leading layer axes of packed planes: (S, kt, rows..., N) linear 4-D
    or conv 6-D, one more for their stacked forms (5-D, 7-D)."""
    return 1 if planes.ndim in (5, 7) else 0


def float_sums_exact(digits: torch.Tensor, a_unsigned: bool) -> torch.Tensor:
    """(lead?, S, k_tiles, N) bool: whether every float64 sum of a tile
    column of float32 ``digits`` ((S, k_tiles, rows, N) as a launch takes
    them, or a whole packed node: the conv's 6-D planes, a stacked node's
    leading layer axis) against integer codes (uint8 when ``a_unsigned``,
    else int8) is exact, whatever order the sum takes.

    A column whose least nonzero digit magnitude is ``lo`` holds only
    multiples of u, the last bit of ``lo``, and u > lo * 2^-24. A partial
    sum of products of codes (at most A = 255 or 128 in magnitude) and
    digits at most ``hi`` is then an integer multiple of u below rows * A
    * hi / u < rows * A * hi * 2^24 / lo, so it is exact in float64 when
    rows * A * hi <= 2^29 * lo. The products themselves are exact (8 bits
    of code by 24 of digit), so the kernel's MMA order and the plain
    version's einsum reach the same float64 sum, which both round once to
    float32. Dead columns pass; a non-finite digit fails."""
    lead = _lead(digits)
    shape = tuple(digits.shape)
    digits = digits.reshape(shape[:lead + 2] + (-1, shape[-1]))
    bound = float(digits.shape[-2] * (255 if a_unsigned else 128))
    mag = digits.abs()
    hi = mag.amax(dim=-2).to(torch.float64)
    inf = torch.tensor(float("inf"), dtype=mag.dtype, device=mag.device)
    lo = torch.where(mag > 0, mag, inf).amin(dim=-2).to(torch.float64)
    return torch.isfinite(hi) & (hi * bound <= lo * 2.0 ** EXACT_BITS)


def _keep_exact(base: torch.Tensor, key, version: int) -> None:
    if id(base) not in _EXACT:
        _EXACT[id(base)] = {}
        weakref.finalize(base, _EXACT.pop, id(base), None)
    _EXACT[id(base)][key] = version


def _one_layer_of(digits: torch.Tensor, base: torch.Tensor) -> bool:
    """Whether the launch's (S, kt, rows, N) ``digits`` are ``base`` (a
    whole packed node) or one layer of it, as the models take them: its
    tile columns are then columns of ``base``."""
    lead = _lead(base)
    layer = base[0] if lead else base
    return (digits.is_contiguous() and base.is_contiguous()
            and tuple(digits.shape[:2]) == tuple(layer.shape[:2])
            and digits.shape[-1] == layer.shape[-1]
            and digits.numel() == layer.numel()
            and (digits.storage_offset() - base.storage_offset())
            % layer.numel() == 0)


def check_float_planes(planes) -> None:
    """Check whole packed nodes' float32 planes (a drift realization's,
    ``core.variation.drift_tree``) with one host read for all of them:
    each tensor that passes ``float_sums_exact`` for both code types is
    kept as shown, so launches on it or on one of its layers skip the
    check. The others are left to their launches, which raise."""
    planes = [p for p in planes if p.dtype == torch.float32]
    if not planes:
        return
    # uint8 codes' bound (255) is the stricter: passing it passes int8's
    oks = torch.stack([float_sums_exact(p, True).all() for p in planes])
    for p, ok in zip(planes, oks.tolist()):
        if ok and p._base is None:
            for unsigned in (True, False):
                _keep_exact(p, ("whole", unsigned), p._version)


def check_float_exact(name: str, digits: torch.Tensor, a_unsigned: bool,
                      what: str = "") -> None:
    """Raise unless ``float_sums_exact`` holds on every column of the
    float32 planes of a launch of the FP64 kernels (``what`` describes the
    call in the message). The result is kept per plane tensor (its base,
    offset, shape and ``_version``), so planes reused across launches are
    checked once, and planes of a node ``check_float_planes`` showed are
    not checked again; the check reads the planes back on the host, so a
    launch under CUDA-graph capture must find its planes checked already
    (run the call once before capturing it)."""
    base = digits if digits._base is None else digits._base
    kept = _EXACT.get(id(base), {})
    key = (digits.storage_offset(), tuple(digits.shape), bool(a_unsigned))
    if kept.get(key) == digits._version or (
            kept.get(("whole", bool(a_unsigned))) == base._version
            and _one_layer_of(digits, base)):
        return
    shape = f"planes {tuple(digits.shape)}" + (f", {what}" if what else "")
    if digits.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: float32 {shape} not checked for exact "
                           "tile sums before a CUDA-graph capture; launch "
                           "once on these planes before capturing")
    ok = float_sums_exact(digits, a_unsigned)
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise ValueError(
            f"{name}: the float-digit kernel cannot show exact tile sums on "
            f"float32 {shape} with {'uint8' if a_unsigned else 'int8'} "
            f"codes: {bad} of {ok.numel()} tile columns span more than "
            f"2^{EXACT_BITS} / (rows x code bound) between their largest "
            "and least nonzero digit magnitudes")
    _keep_exact(base, key, digits._version)


def _relaid_workspace(lib, op: KernelOperands):
    """The relaid-plane workspace of a tensor-core launch on ``op``:
    (workspace, layout id, the id kept before)."""
    return relaid_planes(
        op.digits, lib.cim_matmul_mma_workspace(op.k_tiles, op.n_split,
                                                op.n, 1, op.rows, op.experts),
        (1, op.rows, op.k_tiles * op.rows))


def cim_matmul_cuda(a_t: torch.Tensor, digits: torch.Tensor,
                    s_p: torch.Tensor, deq: torch.Tensor,
                    occ: torch.Tensor | None = None, *, psum_bits: int,
                    psum_quant: bool = True) -> torch.Tensor:
    """out (M, N) float32 = sum_t sum_s deq * ADC(a_t[:, t] @ digits[s, t]).

    a_t     (M, k_tiles, rows) int8 or uint8 activation codes
    digits  (S, k_tiles, rows, N) int8 or float32 (planes carrying cell
            variation), or nibble-packed uint8 (S, k_tiles, rows // 2, N)
            in one half-split block
    s_p     (S, k_tiles, N) ADC scales
    deq     (S, k_tiles, N) fused dequant scales
    occ     optional (S, k_tiles, N) uint8 occupancy map of the planes
    """
    if a_t.device.type == "cpu":
        return ref.cim_matmul_ref(a_t, logical_digits(digits), s_p, deq,
                                  psum_bits=psum_bits, psum_quant=psum_quant)
    op = kernel_operands("cim_matmul_cuda", a_t, digits, occ, s_p=s_p,
                         deq=deq)
    if op.m == 0:
        return op.out
    floats = digits.dtype == torch.float32
    lib = _build.load("cim_matmul" if floats else _MMA)
    occ_ptr = op.occ.data_ptr() if op.occ is not None else None
    ptrs = (a_t.data_ptr(), digits.data_ptr(), occ_ptr,
            op.cols["s_p"].data_ptr(), op.cols["deq"].data_ptr(),
            op.out.data_ptr())
    with torch.cuda.device(a_t.device):
        stream = torch.cuda.current_stream(a_t.device).cuda_stream
        if floats:
            check_float_exact("cim_matmul_cuda", digits, op.a_unsigned)
            work = float_workspace(lib, a_t.device, op.k_tiles, op.n_split,
                                   op.n, 1, op.rows)
            rc = lib.cim_matmul_launch(*ptrs, work.data_ptr(), work.numel(),
                                       *op.shape_args(), op.a_unsigned,
                                       psum_bits, int(psum_quant), stream)
        else:
            work, layout, kept = _relaid_workspace(lib, op)
            nterms = lib.cim_matmul_mma_terms_bytes(*op.shape_args())
            terms = (torch.empty(nterms // 4, dtype=torch.float32,
                                 device=a_t.device) if nterms else None)
            rc = lib.cim_matmul_mma_launch(
                *ptrs, work.data_ptr(), work.numel(), ctypes.byref(layout),
                terms.data_ptr() if terms is not None else None, nterms,
                *op.shape_args(), op.a_unsigned, op.nibble, psum_bits,
                int(psum_quant), stream)
    if floats:
        raise_on_error(lib, rc, "cim_matmul")
    else:
        raise_on_error(lib, rc, "cim_matmul_mma",
                       "cim_matmul_mma_error_string")
        check_capture(layout, kept, "cim_matmul_cuda")
    cim_matmul_cuda.launches += 1
    cim_matmul_cuda.float_launches += int(floats)
    return op.out


cim_matmul_cuda.launches = 0
cim_matmul_cuda.float_launches = 0


def cim_matmul_experts_cuda(a_t: torch.Tensor, digits: torch.Tensor,
                            s_p: torch.Tensor, deq: torch.Tensor,
                            occ: torch.Tensor | None = None, *,
                            psum_bits: int, psum_quant: bool = True,
                            counts: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The CIM matmul of every expert of an MoE bank in one launch:
    out[e] = cim_matmul_cuda(a_t[e], digits[e], s_p[e], deq[e], occ[e]),
    bit for bit, with the rows at or past ``counts[e]`` taken as all-zero
    code rows.

    a_t     (E, C, k_tiles, rows) int8 or uint8 activation codes
    digits  (E, S, k_tiles, rows, N) int8, or nibble-packed uint8 (E, S,
            k_tiles, rows // 2, N)
    s_p     (E, S, k_tiles, N) ADC scales
    deq     (E, S, k_tiles, N) fused dequant scales
    occ     optional (E, S, k_tiles, N) uint8 occupancy maps
    counts  optional (E,) int32 on the codes' device: expert e's filled
            capacity slots, rows 0 .. counts[e] - 1 of its buffer (the MoE
            dispatch fills a prefix). The kernel reads no code of a row at
            or past them, and no plane of an expert with none; those rows
            still get a value, that of an all-zero code row. None: every
            row is computed.

    Planes carrying cell variation (float32) are not taken, as in the
    reference: they go through ``cim_matmul_cuda`` one expert at a time.
    Returns (E, C, N) float32."""
    if digits.dtype == torch.float32:
        raise TypeError("cim_matmul_experts_cuda: float32 (cell-variation) "
                        "planes take the per-expert kernel")
    if a_t.device.type == "cpu":
        return ref.cim_matmul_experts_ref(a_t, logical_digits(digits), s_p,
                                          deq, psum_bits=psum_bits,
                                          psum_quant=psum_quant,
                                          counts=counts)
    op = kernel_operands("cim_matmul_experts_cuda", a_t, digits, occ,
                         experts=True, s_p=s_p, deq=deq)
    if counts is not None and (counts.dtype != torch.int32
                               or tuple(counts.shape) != (op.experts,)
                               or counts.device != a_t.device
                               or not counts.is_contiguous()):
        raise ValueError(f"cim_matmul_experts_cuda: counts must be a "
                         f"contiguous ({op.experts},) int32 tensor on "
                         f"{a_t.device}")
    if op.m == 0 or op.experts == 0:
        return op.out
    lib = _build.load(_MMA)
    work, layout, kept = _relaid_workspace(lib, op)
    with torch.cuda.device(a_t.device):
        rc = lib.cim_matmul_experts_mma_launch(
            a_t.data_ptr(), digits.data_ptr(),
            op.occ.data_ptr() if op.occ is not None else None,
            op.cols["s_p"].data_ptr(), op.cols["deq"].data_ptr(),
            op.out.data_ptr(),
            counts.data_ptr() if counts is not None else None,
            work.data_ptr(), work.numel(), ctypes.byref(layout),
            *op.shape_args(), op.a_unsigned, op.nibble, psum_bits,
            int(psum_quant), op.experts,
            torch.cuda.current_stream(a_t.device).cuda_stream)
    raise_on_error(lib, rc, "cim_matmul_experts_mma",
                   "cim_matmul_mma_error_string")
    check_capture(layout, kept, "cim_matmul_experts_cuda")
    cim_matmul_experts_cuda.launches += 1
    return op.out


cim_matmul_experts_cuda.launches = 0
