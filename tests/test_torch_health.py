"""The port's drift monitor (``repro_torch.serve.health``) against the JAX
package's, on the CPU.

A ``DriftMonitor`` fed the same stream gives the same score, the same
flags and the same ``snapshot()`` as the reference's at every step, on
the cases of ``tests/test_drift.py``: the detection of a shift and its
reset by a recalibration, non-finite values, the std floor of a constant
baseline, no latch before the warmup (also for a statistic that appears
late), warmup 0, and the hysteresis after a recalibration. The
statistic extractors match the reference's at rtol 1e-6 (population
variances).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import health as jh
from repro_torch.serve import health as th


def _shift_stream():
    rng = np.random.RandomState(0)
    return ([{"m": 1.0 + 0.05 * rng.randn()} for _ in range(16)]
            + [{"m": 2.0 + 0.05 * rng.randn()} for _ in range(20)]
            + ["recal"] + [{"m": 2.0 + 0.05 * rng.randn()}
                           for _ in range(6)])


#: (HealthConfig keywords, stream); "recal" is ``note_recalibration()``
STREAMS = {
    "shift_and_recalibration": (
        dict(warmup=16, soft_threshold=4.0, hard_threshold=8.0),
        _shift_stream()),
    "non_finite_and_std_floor": (
        dict(warmup=4),
        [{"m": 1.0}] * 4 + [{"m": float("nan")}, {"m": float("inf")},
                            {"m": 1.5}, {"m": 1.5, "n": float("-inf")}]),
    "no_latch_before_warmup": (
        dict(warmup=8, soft_threshold=0.0, hard_threshold=0.0),
        [{"m": float(i * 100)} for i in range(7)] + [{"m": 3.0}] * 3),
    "late_statistic_reopens_the_gate": (
        dict(warmup=2, soft_threshold=0.0, hard_threshold=0.0),
        [{"a": 1.0}] * 3 + [{"a": 1.0, "b": 5.0}] + [{"a": 1.2, "b": 5.5}]
        * 3),
    "warmup_zero": (dict(warmup=0), [{"m": 1.0}, {"m": 1.1}, {"m": 0.7}]),
    "hysteresis_after_recalibration": (
        dict(warmup=4, soft_threshold=1.0, hard_threshold=1.0, hysteresis=3,
             ewma=1.0),
        [{"m": 1.0}] * 4 + [{"m": 100.0}, "recal"] + [{"m": 100.0}] * 5),
    "several_statistics": (
        dict(warmup=3, soft_threshold=2.0, hard_threshold=6.0, ewma=0.5),
        [{"logit_mean": 0.1 * i, "logit_var": 2.0 + 0.01 * i,
          "logit_margin": 1.0 / (1 + i), "adc_clip_rate": 0.01 * (i % 3)}
         for i in range(12)]),
}


def _state(mon):
    return dict(score=mon.score, drifted=mon.drifted,
                hard_drifted=mon.hard_drifted, drifted_at=mon.drifted_at,
                warmed_up=mon.warmed_up, in_grace=mon.in_grace,
                snapshot=mon.snapshot())


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_monitor_equals_the_references_at_every_step(case):
    kw, stream = STREAMS[case]
    mon = th.DriftMonitor(th.HealthConfig(**kw))
    ref = jh.DriftMonitor(jh.HealthConfig(**kw))
    assert mon.config.effective_warmup() == ref.config.effective_warmup()
    for obs in stream:
        if obs == "recal":
            mon.note_recalibration()
            ref.note_recalibration()
        else:
            s, js = mon.observe(obs), ref.observe(obs)
            assert s == js and np.isfinite(s)
        assert _state(mon) == _state(ref)


def test_monitor_cases_behave_as_the_reference_tests_say():
    """The reference's own assertions, on the port's monitor."""
    kw, stream = STREAMS["shift_and_recalibration"]
    mon = th.DriftMonitor(th.HealthConfig(**kw))
    for obs in stream[:16]:
        mon.observe(obs)
    assert mon.warmed_up and not mon.drifted
    for obs in stream[16:36]:
        mon.observe(obs)
    assert mon.drifted and mon.hard_drifted and mon.drifted_at is not None
    mon.note_recalibration()
    assert mon.recalibrations == 1 and mon.score == 0.0 and not mon.drifted
    kw, stream = STREAMS["hysteresis_after_recalibration"]
    mon = th.DriftMonitor(th.HealthConfig(**kw))
    latched_at, since = None, None
    for obs in stream:
        if obs == "recal":
            mon.note_recalibration()
            assert not mon.hard_drifted and mon.in_grace
            since = 0
            continue
        mon.observe(obs)
        if since is not None:
            since += 1
            if latched_at is None and mon.hard_drifted:
                latched_at = since
    assert latched_at == kw["hysteresis"]


@pytest.mark.parametrize("shape", [(4, 33), (2, 3, 17)])
def test_logit_stats_match_reference(shape):
    logits = np.random.RandomState(2).randn(*shape).astype(np.float32) * 3
    got = th.logit_stats(torch.from_numpy(logits))
    want = jh.logit_stats(jnp.asarray(logits))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    dev = th.logit_stats_device(torch.from_numpy(logits))
    assert {k: float(v) for k, v in dev.items()} == got


def test_tap_stats_match_reference():
    rng = np.random.RandomState(3)
    taps = {"s1.conv1": rng.randn(2, 4, 4, 8).astype(np.float32),
            "s2.proj": (rng.randn(2, 2, 2, 16) * 5 + 1).astype(np.float32)}
    got = th.tap_stats({k: torch.from_numpy(v) for k, v in taps.items()})
    want = jh.tap_stats({k: jnp.asarray(v) for k, v in taps.items()})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
