"""The traced slice of a run: ``torch.profiler`` over a few whole units
of work (batches or steps) in the middle of the window, reduced in
memory to what the per-layer metrics read. Nothing is written to disk.

The slice starts and ends on a drained device (one synchronize each
side), so it holds exactly the kernels of its own units. Busy time is
the union of the device's activity intervals (kernels, copies, sets)
inside the slice; an idle gap is labelled by the benchmark's span and
the innermost host operation running when it began.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

#: the benchmark's own host spans carry this prefix
SPAN = "bench."
SLICE = SPAN + "slice"
#: idle gaps labelled (the longest), and entries of each breakdown list
LABELLED_GAPS = 400
TOP = 10
#: host events looked back through for a gap's label
SCAN = 20000


@dataclasses.dataclass
class Slice:
    """What a slice's trace leaves: device intervals and host events in
    seconds, the slice's bounds, and the units of work it held."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    start: float
    end: float
    units: int

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def device_s(self, pick=lambda name: True) -> float:
        """Summed device time of the intervals whose name ``pick`` takes."""
        return sum(e - s for n, s, e in self.device if pick(n))

    def count(self, pick) -> int:
        return sum(1 for n, _, _ in self.device if pick(n))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, s, e in sorted(self.device, key=lambda v: v[1]):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def breakdown(self) -> Dict[str, list]:
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            ops[n[:120]] += e - s
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])
        host = sorted(self.host, key=lambda v: v[1])
        starts = [s for _, s, _ in host]
        by_label: Dict[str, float] = defaultdict(float)
        for g0, g1 in gaps[:LABELLED_GAPS]:
            by_label[self._label(host, starts, g0)] += g1 - g0
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(by_label)}

    @staticmethod
    def _label(host, starts, t: float) -> str:
        """The benchmark span and the innermost other host event that
        contain ``t``."""
        span = inner = None
        hi = bisect.bisect_right(starts, t) - 1
        for i in range(hi, max(hi - SCAN, -1), -1):
            name, s, e = host[i]
            if e <= t or name == SLICE:
                continue
            if name.startswith(SPAN):
                span = span or name[len(SPAN):]
                break
            inner = inner or name
        return f"{span or 'none'}/{inner or 'none'}"


def _events(prof):
    """(name, is_device, start_s, end_s) of every traced event."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        yield e.name(), e.device_type() == cuda, start, \
            start + e.duration_ns() * 1e-9


def reduce(prof, units: int) -> Slice:
    """The slice of ``prof`` between the bounds of its ``bench.slice``
    span; the device's own copies of the benchmark's spans are dropped."""
    device, host, bounds = [], [], None
    for name, on_device, s, e in _events(prof):
        if name.startswith(SPAN):
            if on_device:
                continue
            if name == SLICE:
                bounds = (s, e)
        (device if on_device else host).append((name, s, e))
    if bounds is None:
        raise RuntimeError("the profile holds no bench.slice span")
    s0, s1 = bounds
    device = [(n, max(s, s0), min(e, s1)) for n, s, e in device
              if e > s0 and s < s1]
    return Slice(device, host, s0, s1, units)


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over the CPU and the card, the slice span open
    inside it; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SLICE):
            yield prof
            torch.cuda.synchronize()


def span(name: str):
    """A benchmark span: a profiler annotation when one is recording,
    otherwise free."""
    from torch.autograd.profiler import record_function
    return record_function(SPAN + name)
