"""Metrics registry: counters, gauges, histograms (DESIGN.md §12), the
port's own copy of ``repro.obs.metrics``.

Plain host-side state — nothing here touches a device. The registry is
the single sink for the serving plane (``serve.engine``) and the kernel
ADC counters (``repro_torch.obs.adc``); one
``snapshot()`` (JSON-safe dict) or ``to_prometheus()`` (text exposition)
call exports everything.

Histograms keep raw observations (capped — see ``Histogram``) so
percentiles are computed exactly at snapshot time with numpy-compatible
linear interpolation, rather than approximated from fixed buckets.

``log_event`` appends structured events (request lifecycle, spans,
recalibrations) to an in-memory ring and, when the registry was built
with ``event_log_path``, to a JSONL file — one JSON object per line,
each stamped with ``ts`` (epoch seconds) and ``kind``.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, List, Optional


class Counter:
    """Monotonic counter. ``inc`` only; reset via the registry."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value-wins instantaneous measurement."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Raw-sample histogram with exact (numpy-interpolation) percentiles.

    Observations are kept verbatim up to ``max_samples``; past the cap
    the stream is decimated — every ``stride``-th observation is kept
    and the stride doubles each time the buffer refills — so memory is
    bounded while ``count``/``sum`` stay exact and percentiles degrade
    gracefully to a uniform subsample of the stream.
    """

    __slots__ = ("name", "count", "sum", "min", "max",
                 "_values", "_max_samples", "_stride", "_skip")

    def __init__(self, name: str, max_samples: int = 65536):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._values: List[float] = []
        self._max_samples = max_samples
        self._stride = 1
        self._skip = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if self._skip:
            self._skip -= 1
            return
        self._skip = self._stride - 1
        self._values.append(v)
        if len(self._values) >= self._max_samples:
            self._values = self._values[::2]
            self._stride *= 2

    def percentile(self, q: float) -> float:
        """q in [0, 100]; linear interpolation between closest ranks —
        the same convention as ``numpy.percentile``'s default."""
        if not self._values:
            return math.nan
        vs = sorted(self._values)
        rank = (q / 100.0) * (len(vs) - 1)
        lo = int(math.floor(rank))
        hi = int(math.ceil(rank))
        if lo == hi:
            return vs[lo]
        return vs[lo] + (vs[hi] - vs[lo]) * (rank - lo)

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


def _sanitize(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:]; dots become
    underscores (``serve.queue.depth`` -> ``serve_queue_depth``)."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


class MetricsRegistry:
    """Get-or-create registry of named metrics + structured event log.

    Thread-safe for creation (the engine and a metrics exporter may race
    on first touch); individual metric updates are GIL-atomic appends /
    adds, which is the granularity this plane needs.
    """

    def __init__(self, event_log_path: Optional[str] = None,
                 max_events: int = 8192):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._events: List[Dict[str, Any]] = []
        self._max_events = max_events
        self.event_log_path = event_log_path
        self._event_file = None
        if event_log_path:
            self._event_file = open(event_log_path, "a", encoding="utf-8")

    # -- metric accessors ---------------------------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name)
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name)
            return self._gauges[name]

    def histogram(self, name: str, max_samples: int = 65536) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, max_samples)
            return self._histograms[name]

    # -- events -------------------------------------------------------------

    def log_event(self, kind: str, **fields: Any) -> Dict[str, Any]:
        ev = {"ts": time.time(), "kind": kind, **fields}
        self._events.append(ev)
        if len(self._events) > self._max_events:
            del self._events[: len(self._events) - self._max_events]
        if self._event_file is not None:
            self._event_file.write(json.dumps(ev) + "\n")
            self._event_file.flush()
        return ev

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e["kind"] == kind]

    # -- export -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe view of every metric. Percentiles are computed here
        (from the raw samples), so the snapshot is self-contained."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {n: h.summary()
                           for n, h in self._histograms.items()},
        }

    def reset(self) -> None:
        """Zero every metric and drop buffered events (the JSONL file, if
        any, is append-only and survives). Metric objects handed out
        earlier stay registered but restart from empty."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
            for name, h in list(self._histograms.items()):
                self._histograms[name] = Histogram(name, h._max_samples)
            self._events.clear()

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): counters and
        gauges verbatim, histograms as summaries with p50/p90/p99
        quantiles plus ``_sum``/``_count``."""
        lines: List[str] = []
        for n, c in sorted(self._counters.items()):
            pn = _sanitize(n)
            lines += [f"# TYPE {pn} counter", f"{pn} {c.value}"]
        for n, g in sorted(self._gauges.items()):
            pn = _sanitize(n)
            lines += [f"# TYPE {pn} gauge", f"{pn} {g.value}"]
        for n, h in sorted(self._histograms.items()):
            pn = _sanitize(n)
            lines.append(f"# TYPE {pn} summary")
            if h.count:
                for q in ("0.5", "0.9", "0.99"):
                    val = h.percentile(float(q) * 100)
                    lines.append(f'{pn}{{quantile="{q}"}} {val}')
            lines.append(f"{pn}_sum {h.sum}")
            lines.append(f"{pn}_count {h.count}")
        return "\n".join(lines) + "\n"
