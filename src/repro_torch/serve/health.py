"""Online drift detection for the serving engine (DESIGN.md §11),
counterpart of ``repro.serve.health``.

The monitor ingests per-step activation statistics — the same
``return_taps``-style summaries the models already expose (per-layer
activation mean/var) plus logit statistics (mean/var and the top-1/top-2
margin) — and maintains one exponentially-weighted moving average per
statistic. The first ``warmup`` observations *calibrate* the detector:
their mean and standard deviation define each statistic's healthy
baseline, so thresholds are in z-units of the serving workload's own
step-to-step variability rather than absolute magnitudes. After warmup
the drift score is

    score = max_k |ewma_k - mu_k| / max(sd_k, floor_k)

i.e. the worst standardized EWMA excursion across all tracked
statistics. ``soft_threshold`` marks detected drift (recalibration is
warranted); ``hard_threshold`` marks serving-quality danger — the engine
reacts by falling back to its digital reference backend until a
recalibration lands (serve/engine.py).

Hysteresis is explicit and deterministic. ``drifted``/``hard_drifted``
are gated on two conditions besides the score:

* **warmup**: every tracked statistic must have finished its baseline
  (``warmed_up``). A statistic mid-calibration has no meaningful z-score,
  so scores computed while any baseline is still forming never latch —
  including a statistic that first appears late (e.g. the ADC clip rate
  arriving only once sampling is armed).
* **post-recalibration grace**: ``note_recalibration()`` opens a
  deterministic grace window — the flags stay suppressed until
  ``hysteresis`` further observations have been folded; the
  ``hysteresis``-th observation after the recalibration is the first
  that can re-assert them. The EWMAs are re-seeded on the baseline at
  the same moment, so past the window the flags re-assert only if the
  *fresh* statistics still excurse — a recalibration that actually fixed
  the chip stays green, a cosmetic one goes red again ``hysteresis``
  observations later, always at the same step for the same input stream.

The monitor is plain host-side state: it holds Python floats, never
touches a device, and costs a handful of float ops per step. The
statistic extractors read their tensors back to the host; variances are
population variances, as the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import torch


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector knobs. ``ewma`` is the smoothing factor (weight of the
    newest observation); ``min_std_frac`` floors the baseline std at a
    fraction of the baseline mean's magnitude so deterministic
    statistics (greedy decode loops) don't divide by zero."""

    ewma: float = 0.25
    warmup: int = 8
    soft_threshold: float = 4.0     # z-units: drift detected, recalibrate
    hard_threshold: float = 12.0    # z-units: degrade, serve fallback
    min_std_frac: float = 0.02
    min_std_abs: float = 1e-6
    hysteresis: int = 4             # post-recal observations before re-latch

    def effective_warmup(self) -> int:
        """Baseline length actually used: ``warmup=0`` would leave a
        statistic with no baseline at all (mean/std of nothing), so the
        floor is one observation."""
        return max(1, self.warmup)


@dataclasses.dataclass
class _Stat:
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0                 # Welford accumulator over warmup
    ewma: Optional[float] = None

    def std(self) -> float:
        return math.sqrt(self.m2 / self.n) if self.n > 1 else 0.0


class DriftMonitor:
    """Running drift detector over a dict of scalar statistics."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self._stats: Dict[str, _Stat] = {}
        self.steps = 0
        self.score = 0.0
        self.drifted_at: Optional[int] = None   # step of first soft crossing
        self.hard_events = 0
        self.recalibrations = 0
        self._grace = 0             # post-recal observations still to skip

    # -- ingestion -----------------------------------------------------------

    def observe(self, stats: Mapping[str, float]) -> float:
        """Fold one step's statistics in; returns the current score."""
        cfg = self.config
        self.steps += 1
        if self._grace > 0:
            self._grace -= 1
        score = 0.0
        for name, value in stats.items():
            v = float(value)
            if not math.isfinite(v):
                continue
            st = self._stats.setdefault(name, _Stat())
            if st.n < cfg.effective_warmup():
                # calibration phase: accumulate the healthy baseline
                st.n += 1
                d = v - st.mean
                st.mean += d / st.n
                st.m2 += d * (v - st.mean)
                st.ewma = v if st.ewma is None else (
                    cfg.ewma * v + (1 - cfg.ewma) * st.ewma)
                continue
            st.ewma = cfg.ewma * v + (1 - cfg.ewma) * st.ewma
            floor = max(cfg.min_std_abs, cfg.min_std_frac * abs(st.mean))
            z = abs(st.ewma - st.mean) / max(st.std(), floor)
            score = max(score, z)
        self.score = score
        if self.drifted and self.drifted_at is None:
            self.drifted_at = self.steps
        return score

    def note_recalibration(self) -> None:
        """A recalibration landed: count it, re-seed the EWMAs on the
        baseline so the score relaxes immediately instead of waiting out
        the smoothing horizon (the drifted history is no longer serving
        reality), clear the latch, and open the ``hysteresis`` grace
        window (module docstring)."""
        self.recalibrations += 1
        for st in self._stats.values():
            if st.n > 0:
                st.ewma = st.mean
        self.score = 0.0
        self.drifted_at = None
        self._grace = self.config.hysteresis

    # -- queries -------------------------------------------------------------

    @property
    def warmed_up(self) -> bool:
        w = self.config.effective_warmup()
        return bool(self._stats) and all(
            s.n >= w for s in self._stats.values())

    @property
    def in_grace(self) -> bool:
        """Inside the post-recalibration hysteresis window."""
        return self._grace > 0

    @property
    def drifted(self) -> bool:
        return (self.warmed_up and not self.in_grace
                and self.score >= self.config.soft_threshold)

    @property
    def hard_drifted(self) -> bool:
        return (self.warmed_up and not self.in_grace
                and self.score >= self.config.hard_threshold)

    def snapshot(self) -> Dict[str, object]:
        """Counters + per-stat state for an engine ``health()`` call."""
        return {
            "steps": self.steps,
            "score": self.score,
            "drifted": self.drifted,
            "hard_drifted": self.hard_drifted,
            "drifted_at": self.drifted_at,
            "hard_events": self.hard_events,
            "recalibrations": self.recalibrations,
            "warmed_up": self.warmed_up,
            "grace": self._grace,
            "stats": {
                name: {"baseline_mean": st.mean, "baseline_std": st.std(),
                       "ewma": st.ewma, "n": st.n}
                for name, st in self._stats.items()
            },
        }


# ---------------------------------------------------------------------------
# statistic extractors (host-side, one float per entry)
# ---------------------------------------------------------------------------

def tap_stats(taps: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Per-layer activation mean/var from a ``return_taps`` dict."""
    out: Dict[str, float] = {}
    for name, a in taps.items():
        af = torch.as_tensor(a).to(torch.float32)
        out[f"{name}.mean"] = float(torch.mean(af))
        out[f"{name}.var"] = float(torch.var(af, correction=0))
    return out


def logit_stats(logits) -> Dict[str, float]:
    """Mean/var and mean top-1/top-2 margin of a (..., V) logit batch:
    the margin collapses first under drift (wrong tokens start winning),
    which makes it the most sensitive single statistic."""
    return {k: float(v) for k, v in logit_stats_device(logits).items()}


def logit_stats_device(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``logit_stats`` as 0-d float32 tensors on the logits' device (no
    host read), for a caller that reads them back later."""
    lf = torch.as_tensor(logits).to(torch.float32).reshape(
        -1, logits.shape[-1])
    t2 = torch.topk(lf, 2, dim=-1).values
    return {
        "logit_mean": torch.mean(lf),
        "logit_var": torch.var(lf, correction=0),
        "logit_margin": torch.mean(t2[:, 0] - t2[:, 1]),
    }
