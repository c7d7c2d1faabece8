"""Degraded serving and recovery on the port against the JAX package's
engine, on the CPU, on the drifting chip of ``test_torch_serve_drift.py``
(the reduced moonshot-v1-16b-a3b packed by the JAX package, the JAX
package's drift fields handed in by ``JaxDriftSource``).

With the monitor's thresholds at 0, hard drift trips the fallback at the
reference's step, and the tokens agree with the reference's throughout;
the fallback serves the ``ref`` backend on the pristine planes (a ``ref``
engine's slot run, token for token); ``recalibrate`` on the reference's
probe codes gives the reference's ``s_p`` and ``deq_scale`` and the same
tokens after it, clears the fallback and counts one recalibration; the
counters, gauges and histogram counts of ``metrics()`` and the event log
equal the reference's.

The artifact carries a unit ``deq_scale`` on every node from the start
(an identity delta, which changes no value): a recalibration then keeps
the tree's structure, so the reference's jitted step is traced once.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_drift_source import JaxDriftSource
from repro.configs.registry import get_config as j_get_config
from repro.core import variation as jvar
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.eval import recalibrate as jrec
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.serve import health as jh
from repro.serve.engine import engine_from_artifact as j_engine_from_artifact
from repro_torch import api as tapi
from repro_torch.configs.registry import get_config
from repro_torch.core import variation as tvar
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.eval import recalibrate as rec
from repro_torch.interop import from_numpy_tree
from repro_torch.obs import names as M
from repro_torch.serve import health as th
from repro_torch.serve.engine import engine_from_artifact
from test_torch_serve_drift import (ARCH, CIM, NEW, SCHED, T0, _j_artifact,
                                    _slot_run)

CPU = "cpu"
#: a monitor that trips as soon as it is warm
TRIP = dict(warmup=2, soft_threshold=0.0, hard_threshold=0.0)
PROBES = 8


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _unit_delta(params):
    """Gain 1 for every packed node of ``params``."""
    gains = {}
    for path, leaf in _leaves(params):
        if path[-1] == "w_digits":
            shape = leaf.shape[:-2] + leaf.shape[-1:]
            gains["/".join(path[:-1])] = np.ones(shape, np.float32)
    return jrec.ScaleDelta(gains=gains)


@pytest.fixture(scope="module")
def ref():
    jcfg = j_get_config(ARCH, reduced=True, cim=JCIMConfig(**CIM)).replace(
        compute_dtype="float32", remat=False)
    jmodel = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(jmodel.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    art = _j_artifact(params, jcfg)
    art = art.__class__(kind=art.kind, config=art.config, meta=art.meta,
                        params=jrec.apply_scale_delta_params(
                            art.params, _unit_delta(art.params)))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 6), 0,
                                            jcfg.vocab), np.int32)
    dkey, pkey = jax.random.PRNGKey(7), jax.random.PRNGKey(9)
    eng = j_engine_from_artifact(art, jcfg, batch_size=2, max_len=32,
                                 drift_key=dkey,
                                 drift_schedule=jvar.DriftSchedule(**SCHED),
                                 health=jh.DriftMonitor(jh.HealthConfig(
                                     **TRIP)))
    eng.t = T0
    out = {"artifact": art, "prompts": prompts, "key": dkey, "pkey": pkey}
    out["trip_batch"] = eng.generate_batch(prompts, NEW + 1)
    out["trip_health"] = eng.health()
    out["trip_slots"] = _slot_run(eng)
    out["delta"] = eng.recalibrate(probes=PROBES, key=pkey)
    out["recal_params"] = dict(_leaves(jax.tree.map(np.asarray, eng.params)))
    out["recal_health"] = eng.health()
    out["recal_batch"] = eng.generate_batch(prompts, NEW)
    out["final_health"] = eng.health()
    out["metrics"] = eng.metrics()
    out["events"] = [e["kind"] for e in eng.registry.events()]
    return out


@pytest.fixture(scope="module")
def served(ref):
    """The port's engine through the reference's sequence."""
    art = ref["artifact"]
    tcfg = get_config(ARCH, reduced=True, cim=TCIMConfig(**CIM)).replace(
        compute_dtype="float32", remat=False)
    params = from_numpy_tree(jax.tree.map(np.asarray, art.params), CPU)
    tart = tapi.DeployArtifact(kind="model", config=TCIMConfig(
        **CIM).replace(mode="deploy"), params=params, meta=dict(art.meta))
    eng = engine_from_artifact(tart, tcfg, batch_size=2, max_len=32,
                               device=CPU, drift_key=JaxDriftSource(ref["key"]),
                               drift_schedule=tvar.DriftSchedule(**SCHED),
                               health=th.DriftMonitor(th.HealthConfig(**TRIP)))
    eng.t = T0
    out = {"artifact": tart, "cfg": tcfg, "engine": eng}
    out["trip_batch"] = eng.generate_batch(ref["prompts"], NEW + 1)
    out["trip_health"] = eng.health()
    out["trip_slots"] = _slot_run(eng)
    codes = {}
    for path, leaf in _leaves(params):
        if path[-1] == "w_digits":
            planes = rec._row_flat(leaf)
            codes["/".join(path[:-1])] = np.asarray(jax.random.rademacher(
                jvar.path_fold_key(ref["pkey"], path[:-1]),
                (PROBES, planes.shape[-3], planes.shape[-2]), jnp.float32))
    out["delta"] = eng.recalibrate(probes=PROBES, codes=codes)
    out["recal_params"] = dict(_leaves(eng.params))
    out["recal_health"] = eng.health()
    out["recal_batch"] = eng.generate_batch(ref["prompts"], NEW)
    out["final_health"] = eng.health()
    return out


def test_hard_drift_trips_the_fallback_at_the_references_step(ref, served):
    np.testing.assert_array_equal(served["trip_batch"], ref["trip_batch"])
    h, want = served["trip_health"], ref["trip_health"]
    assert h["fallback_active"] and want["fallback_active"]
    assert h["drifted_at"] == want["drifted_at"] is not None
    for k in ("hard_events", "steps", "t", "recalibrations", "warmed_up",
              "drifted", "hard_drifted", "grace"):
        assert h[k] == want[k], k


def test_fallback_serves_the_ref_backend_on_pristine_planes(ref, served):
    tart = served["artifact"]
    ref_eng = engine_from_artifact(
        tapi.DeployArtifact(kind="model", params=tart.params,
                            config=tart.config.replace(mode="ref")),
        served["cfg"], batch_size=2, max_len=32, device=CPU)
    assert served["trip_slots"] == ref["trip_slots"] == _slot_run(ref_eng)


def test_recalibrate_on_the_references_probes(ref, served):
    delta, want = served["delta"], ref["delta"]
    assert sorted(delta.gains) == sorted(want.gains)
    assert (delta.layout_version, delta.meta) == (want.layout_version,
                                                  want.meta)
    for name, g in delta.gains.items():
        np.testing.assert_allclose(g.numpy(), want.gains[name], rtol=1e-5,
                                   atol=0, err_msg=name)
    scaled = 0
    for path, leaf in served["recal_params"].items():
        if path[-1] in ("s_p", "deq_scale"):
            scaled += path[-1] == "deq_scale"
            np.testing.assert_allclose(leaf.numpy(), ref["recal_params"][path],
                                       rtol=1e-6, atol=0,
                                       err_msg="/".join(path))
        else:
            np.testing.assert_array_equal(leaf.numpy(),
                                          ref["recal_params"][path])
    assert scaled == len(delta.gains) > 0
    h = served["recal_health"]
    assert not h["fallback_active"] and h["recalibrations"] == 1
    np.testing.assert_array_equal(served["recal_batch"], ref["recal_batch"])
    h, want = served["final_health"], ref["final_health"]
    for k in ("recalibrations", "fallback_active", "hard_events", "t",
              "steps", "drifted_at", "grace"):
        assert h[k] == want[k], k


def test_metrics_equal_the_references(ref, served):
    eng = served["engine"]
    m, jm = eng.metrics(), ref["metrics"]
    assert json.dumps(m)
    assert m["metrics"]["counters"] == jm["metrics"]["counters"]
    assert m["metrics"]["counters"][M.RECALIBRATIONS] == 1
    assert m["metrics"]["gauges"] == jm["metrics"]["gauges"]
    assert ({k: v["count"] for k, v in m["metrics"]["histograms"].items()}
            == {k: v["count"] for k, v in jm["metrics"]["histograms"].items()})
    for k in ("tokens_generated", "decode_steps", "devices"):
        assert m["throughput"][k] == jm["throughput"][k], k
    assert m["throughput"]["tokens_per_sec"] > 0
    assert m["saturation"] is None and jm["saturation"] is None
    assert [e["kind"] for e in eng.registry.events()] == ref["events"]


def test_auto_recalibrate_report_and_shared_registry(ref, served, capsys):
    """``auto_recalibrate`` heals instead of falling back; ``report_every``
    writes the operator's line; ``metrics=`` shares one registry."""
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    eng = engine_from_artifact(
        served["artifact"], served["cfg"], batch_size=2, max_len=32,
        device=CPU, drift_key=JaxDriftSource(ref["key"]),
        drift_schedule=tvar.DriftSchedule(**SCHED),
        health=th.DriftMonitor(th.HealthConfig(**TRIP)),
        auto_recalibrate=True, metrics=reg, report_every=2)
    eng.t = T0
    out = eng.generate_batch(ref["prompts"], NEW + 1)
    assert out.shape == (2, NEW + 1)
    h = eng.health()
    assert not h["fallback_active"] and h["recalibrations"] >= 1
    assert h["hard_events"] == h["recalibrations"]
    assert eng.registry is reg
    assert reg.counter(M.RECALIBRATIONS).value == h["recalibrations"]
    assert reg.counter(M.TOKENS_GENERATED).value == 2 * (NEW + 1)
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("[serve.metrics]")]
    assert len(lines) == NEW // 2
    assert "score=" in lines[-1] and "fallback=False" in lines[-1]
