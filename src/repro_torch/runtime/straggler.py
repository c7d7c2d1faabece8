"""Straggler detection & mitigation policy (counterpart of
``repro.runtime.straggler``, line for line).

On a 1000+-node fleet the dominant tail-latency sources are (a) slow hosts
(thermal, ECC retry, flaky HBM), (b) input-pipeline stalls, (c) pre-empted
pods. Synchronous SPMD means the step time is the max over hosts, so the
policy below watches the *local* step-time distribution and classifies:

  WARN     step > warn_factor * rolling median   (log, count)
  CRITICAL step > crit_factor * rolling median   (report to coordinator;
           on real fleets the coordinator hot-swaps the host with a spare
           pod slice and the run restores from the latest checkpoint —
           wired to FaultTolerantLoop.request_restart)

The statistics (rolling median via a bounded reservoir) are unit-tested;
the hot-swap RPC is a no-op hook on a single host.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Optional


class StragglerMonitor:
    def __init__(self, window: int = 64, warn_factor: float = 1.5,
                 crit_factor: float = 3.0, min_samples: int = 8,
                 on_critical: Optional[Callable[[float, float], None]] = None):
        self.window: Deque[float] = deque(maxlen=window)
        self.warn_factor = warn_factor
        self.crit_factor = crit_factor
        self.min_samples = min_samples
        self.on_critical = on_critical
        self.n_warn = 0
        self.n_crit = 0
        self._t0: Optional[float] = None

    # -- timing API -----------------------------------------------------------
    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self) -> str:
        assert self._t0 is not None, "step_start not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(dt)

    # -- pure policy (unit-tested) ---------------------------------------------
    def median(self) -> float:
        s = sorted(self.window)
        n = len(s)
        if n == 0:
            return 0.0
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def observe(self, step_time: float) -> str:
        """Returns 'ok' | 'warn' | 'critical' and updates state."""
        verdict = "ok"
        if len(self.window) >= self.min_samples:
            med = self.median()
            if step_time > self.crit_factor * med:
                verdict = "critical"
                self.n_crit += 1
                if self.on_critical:
                    self.on_critical(step_time, med)
            elif step_time > self.warn_factor * med:
                verdict = "warn"
                self.n_warn += 1
        # stragglers do not poison the baseline: only 'ok' samples enter
        if verdict == "ok":
            self.window.append(step_time)
        return verdict
