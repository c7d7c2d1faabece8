"""Per-column ADC saturation counters (DESIGN.md §12), counterpart of
``repro.obs.adc``.

The leading indicator that a chip (or its calibration) is going bad is
the fraction of partial sums that clip at the ADC range, per physical
column. This module collects that signal from the running forwards:

* **emulate** materializes every partial sum anyway (for the LSQ
  gradients), so its counters are exact: every conversion of every
  forward is counted while armed (``core.cim_linear``,
  ``core.cim_conv``, on the detached partial sums).
* **deploy/ref** never materialize the partial sums (that is the point
  of the fused kernel), so ``kernels/ops.cim_matmul`` / ``cim_conv`` add
  a *side-output* when armed: the partial sums are recomputed by a
  float32 einsum beside the kernel call and reduced to per-column counts.
  The main output is untouched, bit-exact with the disarmed path, and a
  disarmed call runs no side computation at all.

The reference ships each call's counts to the host with a
``jax.debug.callback``. Here ``record`` never reads the device: each
folded call's ``(saturated, occupancy)`` tensors are kept as they are,
and ``sync()``, ``totals()`` and ``summary()`` fold them on the host in
call order. ``every_n`` keeps the reference's semantics: armed call
``c`` (counted from 1) is folded iff ``(c - 1) % every_n == 0``, and the
calls that will not be folded skip the side computation. ``disable()``
stops recording at once; calls recorded while armed are still folded.
Arming is refused inside a CUDA-graph capture: a captured side-output
would replay without being recorded.

Under a session mesh a record is either whole, the same on every rank
(a layer every rank runs on the whole input), or a part of the whole over
some mesh dims, made inside ``partial_over(axes)``: the columns a rank
serves under the column-parallel dispatch (``kernels.ops``, over
``"model"``), or the experts and tokens of an expert-parallel MoE rank
(``models.layers._apply_moe_ep``, over the batch axes and ``"model"``).
Inside a data parallel step (``nn.module.data_parallel``) every record is
also a part over the batch axes: the rank's rows. ``totals()`` and
``summary()`` count the whole records once and sum each part over its
dims (the worst column rate is the largest over the mesh):
collectives, so every rank calls them together. The totals equal the
single device's counts, as the reference's host callbacks count them on
a mesh of devices (a replicated layer once, a ``shard_map`` body's records
on every device).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import names
from .metrics import MetricsRegistry


class _AdcState:
    """Module-level collector state (one serving process, one card)."""

    def __init__(self):
        self.enabled = False
        self.every_n = 1
        self.registry: Optional[MetricsRegistry] = None
        self.calls = 0                  # armed kernel invocations seen
        self.saturated_total = 0        # folded clipped conversions
        self.conversions_total = 0      # folded conversions
        self.worst_col_rate = 0.0       # max per-column rate ever folded
        self.last_col_rates: Optional[np.ndarray] = None
        self.last_col_occupancy: Optional[np.ndarray] = None
        # recorded, not yet folded: (sat, occ, conversions per column, the
        # mesh dims the record is a part over)
        self.pending: List[Tuple[torch.Tensor, torch.Tensor, int,
                                 Tuple[str, ...]]] = []
        self.partial: Tuple[str, ...] = ()   # dims of records made now
        # folded (saturated, conversions) of the parts, by their dims
        self.parts: Dict[Tuple[str, ...], List[int]] = {}


_STATE = _AdcState()


def enable(registry: Optional[MetricsRegistry] = None,
           every_n: int = 1) -> MetricsRegistry:
    """Arm the collector; returns the sink registry. Raises inside a
    CUDA-graph capture."""
    if every_n < 1:
        raise ValueError(f"every_n must be >= 1, got {every_n}")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("obs.adc.enable: the ADC collector cannot be "
                           "armed inside a CUDA-graph capture (a captured "
                           "side-output would replay unrecorded)")
    _STATE.enabled = True
    _STATE.every_n = every_n
    _STATE.registry = registry if registry is not None else MetricsRegistry()
    return _STATE.registry


def disable() -> None:
    """Disarm: later calls record nothing."""
    _STATE.enabled = False


def enabled() -> bool:
    return _STATE.enabled


def reset() -> None:
    """Zero the collector's own totals and drop what is not folded yet
    (the sink registry is the caller's; reset it separately if wanted)."""
    _STATE.calls = 0
    _STATE.saturated_total = 0
    _STATE.conversions_total = 0
    _STATE.worst_col_rate = 0.0
    _STATE.last_col_rates = None
    _STATE.last_col_occupancy = None
    _STATE.pending = []
    _STATE.parts = {}


#: the mesh dims a record can be a part over, in the order its key
#: lists them (the batch axes, then "model")
_DIMS = ("pod", "data", "model")


@contextmanager
def partial_over(axes):
    """Records made inside are parts of the whole over the mesh dims
    ``axes`` (a rank's columns, or its experts and tokens): ``totals()``
    sums them over those dims."""
    prev, _STATE.partial = _STATE.partial, tuple(axes)
    try:
        yield
    finally:
        _STATE.partial = prev


@contextmanager
def sampled(registry: Optional[MetricsRegistry] = None, every_n: int = 1):
    """Scoped arming for benches and tests: arm, yield the registry,
    disarm and reset on exit."""
    reg = enable(registry, every_n)
    try:
        yield reg
    finally:
        disable()
        reset()


def sync() -> None:
    """Fold every recorded call on the host, in call order (this reads
    the recorded counts back from the device)."""
    pending, _STATE.pending = _STATE.pending, []
    for sat, occ, conv_per_col, axes in pending:
        _fold(sat.cpu().numpy(), occ.cpu().numpy(),
              conv_per_col=conv_per_col, axes=axes)


def _over_mesh() -> Tuple[int, int, float]:
    """(saturated, conversions, worst column rate) folded so far over the
    session mesh: the whole records once, each part summed over its dims
    (the rate: the largest over every dim)."""
    from repro_torch.core.colshard import mesh_shards
    from repro_torch.nn.module import current_mesh
    st = _STATE
    sat, conv, worst = st.saturated_total, st.conversions_total, \
        st.worst_col_rate
    mesh = current_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    dims = [a for a in names if mesh_shards(mesh, a) > 1]
    if not dims:
        return sat, conv, worst
    import torch.distributed as dist

    from repro_torch.launch.mesh import batch_axes
    dev = (torch.device("cpu") if dist.get_backend(
        mesh.get_group(dims[0])) == "gloo"
        else torch.device("cuda", torch.cuda.current_device()))
    # the parts a mesh can hold, the same list on every rank: the
    # column-parallel dispatch's, a data parallel step's rows, and both
    # (also the expert-parallel MoE's)
    rows = batch_axes(mesh)
    kinds = [("model",)] + ([rows, rows + ("model",)] if rows else [])
    if not set(st.parts) <= set(kinds):
        raise RuntimeError(f"ADC records are parts over {sorted(st.parts)}; "
                           f"the session mesh {names} holds parts over "
                           f"{kinds}")
    for axes in kinds:
        part = st.parts.get(axes, [0, 0])
        counts = torch.tensor(part, dtype=torch.int64, device=dev)
        for a in axes:
            if mesh_shards(mesh, a) > 1:
                dist.all_reduce(counts, group=mesh.get_group(a))
        sat += int(counts[0]) - part[0]
        conv += int(counts[1]) - part[1]
    rate = torch.tensor([worst], dtype=torch.float64, device=dev)
    for a in dims:
        dist.all_reduce(rate, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return sat, conv, float(rate[0])


def totals() -> Tuple[int, int]:
    """(saturated, conversions) folded so far, after a ``sync()``, over
    the session mesh; the engine derives its per-step clip-rate drift
    statistic from deltas of these."""
    sync()
    sat, conv, _ = _over_mesh()
    return sat, conv


def summary() -> Dict[str, object]:
    """JSON-safe roll-up for ``engine.metrics()``, after a ``sync()``,
    over the session mesh."""
    sync()
    sat, conv, worst = _over_mesh()
    return {
        "enabled": _STATE.enabled,
        "every_n": _STATE.every_n,
        "kernel_invocations": _STATE.calls,
        "samples_folded": _STATE.calls and (
            (_STATE.calls + _STATE.every_n - 1) // _STATE.every_n),
        "conversions": conv,
        "saturated": sat,
        "clip_rate": (sat / conv) if conv else 0.0,
        "worst_col_rate": worst,
    }


# ---------------------------------------------------------------------------
# the measurement itself
# ---------------------------------------------------------------------------

def saturation_stats(psum: torch.Tensor, s_p: torch.Tensor, psum_bits: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column (last-axis) ADC statistics of a partial-sum tensor.

    psum (..., N) against scales s_p broadcastable to it. Returns
    ``(saturated, occupancy)``: clipped-conversion counts (N,) int32 and
    mean |q|/q_max range occupancy (N,) float32. ``psum_bits == 1`` is
    the sign ADC: it cannot clip and always occupies the full range."""
    n = psum.shape[-1]
    dev = psum.device
    if psum_bits < 2:
        return (torch.zeros((n,), dtype=torch.int32, device=dev),
                torch.ones((n,), dtype=torch.float32, device=dev))
    qn = float(-(2 ** (psum_bits - 1)))
    qp = float(2 ** (psum_bits - 1) - 1)
    q = torch.round(torch.round(psum.to(torch.float32))
                    / torch.clamp_min(s_p.to(torch.float32), 1e-9))
    q = torch.broadcast_to(q, psum.shape).reshape(-1, n)
    sat = ((q < qn) | (q > qp)).sum(dim=0).to(torch.int32)
    occ = torch.mean(torch.abs(torch.clamp(q, qn, qp)) / qp, dim=0)
    return sat, occ


def _fold(sat: np.ndarray, occ: np.ndarray, *, conv_per_col: int,
          axes: Tuple[str, ...] = ()) -> None:
    """Host-side sink for one folded call's per-column counts (a part of
    the whole over the mesh dims ``axes``, when given)."""
    st = _STATE
    if st.registry is None:
        return
    sat = np.asarray(sat, np.int64)
    occ = np.asarray(occ, np.float64)
    n = int(sat.shape[0])
    conv = conv_per_col * n
    st.saturated_total += int(sat.sum())
    st.conversions_total += conv
    if axes:
        part = st.parts.setdefault(axes, [0, 0])
        part[0] += int(sat.sum())
        part[1] += conv
    rates = sat / float(conv_per_col)
    st.worst_col_rate = max(st.worst_col_rate, float(rates.max(initial=0.0)))
    st.last_col_rates = rates
    st.last_col_occupancy = occ
    reg = st.registry
    reg.counter(names.ADC_SAMPLES).inc()
    reg.counter(names.ADC_CONVERSIONS).inc(conv)
    reg.counter(names.ADC_SATURATED).inc(int(sat.sum()))
    h_rate = reg.histogram(names.ADC_COL_SATURATION_RATE)
    h_occ = reg.histogram(names.ADC_OCCUPANCY)
    for r, o in zip(rates, occ):
        h_rate.observe(r)
        h_occ.observe(o)


def will_fold() -> bool:
    """Count one armed call and say whether it will be folded (call
    ``c`` is folded iff ``(c - 1) % every_n == 0``). A caller that gets
    False may skip computing what it would record. Call only under
    ``enabled()``."""
    st = _STATE
    st.calls += 1
    return (st.calls - 1) % st.every_n == 0


def record(psum: torch.Tensor, s_p: torch.Tensor, psum_bits: int) -> None:
    """Reduce ``psum`` to per-column counts and keep them for the host
    fold; reads nothing back from the device. Call only for an armed
    call that ``will_fold()`` counted and chose, and only when the config
    quantizes partial sums."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("obs.adc.record: the ADC collector is armed "
                           "inside a CUDA-graph capture")
    from repro_torch.nn.module import batch_parallel
    sat, occ = saturation_stats(psum.detach(), s_p.detach(), psum_bits)
    conv_per_col = int(np.prod(psum.shape[:-1]))
    dp = batch_parallel()
    over = set(_STATE.partial) | set(dp[1] if dp else ())
    _STATE.pending.append((sat, occ, conv_per_col,
                           tuple(a for a in _DIMS if a in over)))
