"""Canonical metric names (DESIGN.md §12), the port's own copy of
``repro.obs.names``.

Every metric the serving engine, kernels, and benches emit is named
here, not at the emission site — the DESIGN.md §12 table is checked
against the reference's copy by ``tools/check_metrics.py``, and the
port's tests hold these constants equal to the reference's.

Naming scheme: dot-separated ``<plane>.<subsystem>.<what>``; histograms
of durations end in ``.seconds``. Prometheus exposition sanitizes dots
to underscores (``MetricsRegistry.to_prometheus``).
"""
from __future__ import annotations

# -- serving plane (recorded by repro_torch.serve.engine.ServingEngine) ----

#: counter: requests accepted by ``submit()``
REQUESTS_SUBMITTED = "serve.requests.submitted"
#: counter: requests finished and retired from their slot
REQUESTS_COMPLETED = "serve.requests.completed"
#: counter: decode tokens emitted across all slots
TOKENS_GENERATED = "serve.tokens.generated"
#: counter: in-service column-scale recalibrations landed
#: (``ServingEngine.recalibrate`` / eval/recalibrate.py)
RECALIBRATIONS = "serve.recalibrations"
#: gauge: requests waiting in the admission queue
QUEUE_DEPTH = "serve.queue.depth"
#: gauge: slots currently serving a live request
ACTIVE_SLOTS = "serve.slots.active"
#: histogram: submit -> admission wait per request
QUEUE_WAIT_SECONDS = "serve.request.queue_wait.seconds"
#: histogram: submit -> last token per request
REQUEST_LATENCY_SECONDS = "serve.request.latency.seconds"
#: histogram: per-request prefill span (all prompt tokens)
PREFILL_SECONDS = "serve.prefill.seconds"
#: histogram: one engine decode step (all active slots advance one token)
DECODE_STEP_SECONDS = "serve.decode.step.seconds"

# -- CIM / ADC plane (recorded by repro_torch.obs.adc) --------------------

#: counter: kernel invocations folded by the sampled collector
ADC_SAMPLES = "cim.adc.samples"
#: counter: ADC conversions covered by the folded samples
ADC_CONVERSIONS = "cim.adc.conversions"
#: counter: conversions whose partial sum clipped at the ADC range
ADC_SATURATED = "cim.adc.saturated"
#: histogram: per-column saturation rate, one observation per column
#: per folded sample (the paper-native drift signal)
ADC_COL_SATURATION_RATE = "cim.adc.col_saturation_rate"
#: histogram: per-column mean ADC range occupancy |q|/q_max
ADC_OCCUPANCY = "cim.adc.occupancy"
