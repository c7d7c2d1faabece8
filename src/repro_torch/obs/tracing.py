"""Lightweight tracing spans (DESIGN.md §12), the port's own copy of
``repro.obs.tracing``.

A span measures one host-side region — a request's prefill, one decode
step, a recalibration fit — and records on exit:

* a duration observation into ``<name>.seconds`` on the tracer's
  registry (so spans and metrics share one export path), and
* a ``span`` event in the registry's event log carrying the span's
  name, duration, attributes and its parent span's name.

Nesting is tracked per-thread with a plain stack: a span opened inside
another records that span as its parent, which is all the structure the
serving engine needs (request -> prefill -> per-layer would be the next
refinement). A span times the host clock: a caller whose work runs on
the card synchronises with it inside the span (the serving engine reads
its tokens back there), so the span covers the device work too.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry


@dataclasses.dataclass
class SpanRecord:
    """One finished span. ``duration`` in seconds; ``parent`` is the
    enclosing span's name (None at top level)."""

    name: str
    t_start: float
    duration: float
    parent: Optional[str] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Tracer:
    """Span factory bound to one ``MetricsRegistry``.

    >>> tracer = Tracer(registry)
    >>> with tracer.span("serve.prefill", rid=3):
    ...     ...   # registry histogram "serve.prefill.seconds" observes
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_spans: int = 8192):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.spans: List[SpanRecord] = []
        self._max_spans = max_spans
        self._local = threading.local()

    def _stack(self) -> List[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextmanager
    def span(self, name: str, **attrs: Any):
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = time.perf_counter()
        ts = time.time()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            rec = SpanRecord(name=name, t_start=ts, duration=dur,
                             parent=parent, attrs=dict(attrs))
            self.spans.append(rec)
            if len(self.spans) > self._max_spans:
                del self.spans[: len(self.spans) - self._max_spans]
            self.registry.histogram(f"{name}.seconds").observe(dur)
            self.registry.log_event("span", name=name, duration=dur,
                                    parent=parent, **attrs)
