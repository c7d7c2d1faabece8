"""The telemetry plane of the port (DESIGN.md §12), counterpart of
``repro.obs``, which it copies rather than imports (``repro.obs`` imports
jax).

* ``metrics``: a ``MetricsRegistry`` of counters, gauges and histograms
  with a JSON snapshot, reset, a JSONL event log and Prometheus text
  exposition; histogram percentiles are exact (numpy's interpolation).
* ``tracing``: ``Tracer``/``SpanRecord``, nested host-side spans that
  record durations into the registry and events into its log.
* ``adc``: the sampled per-column ADC saturation collector that the
  kernel dispatch and the emulate forwards feed (``cim.adc.*``), off by
  default and free when disarmed.

Canonical metric names live in ``names`` and nowhere else.
"""
from . import adc, names
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import SpanRecord, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SpanRecord", "Tracer", "adc", "names"]
