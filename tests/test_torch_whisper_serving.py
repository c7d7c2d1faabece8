"""whisper served by the port's engine, on the CPU: the reduced
whisper-small packed by the JAX package (``tests/_torch_zoo.py``'s parity
CIM config, float32), its encoder states of numpy log-mel frames in the
engine's cache.

- ``generate_batch`` decodes against the encoder states the caller put in
  ``engine.cache["enc_out"]`` (ROADMAP item 15; the reference's re-inits
  them to zeros, fault 13): without them it raises, with states of
  another batch too; at batch 1 it gives the slot engine's tokens (the
  slot engine emits from the second token on: the last invocation of its
  prompt only feeds the next).

Then recalibration and the fallback on whisper's conv and stacked nodes,
against the JAX package, drifted at ``t = 400`` under
``tests/test_drift.py``'s schedule (a ``Sampler`` source: the fits are
compared on the same drifted planes).

- ``fit_scale_delta`` on the reference's per-node Rademacher probe codes
  gives ``repro.eval.recalibrate.fit_scale_delta``'s gains on the same
  pristine and drifted planes and codes, the two front-end convs' (6-D)
  and the stacked encoder and decoder layers' (a leading layer axis)
  included; ``apply_scale_delta_params`` its ``s_p`` and ``deq_scale``.
- With the monitor's thresholds at 0 the drifting engine trips the
  fallback; the slot engine on the fallback serves a ``ref``-backend
  engine's tokens on the pristine planes (encoder states in both caches),
  and ``recalibrate()`` clears it and puts ``deq_scale`` on the convs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro import api as japi
from repro.core import variation as jvar
from repro.eval import recalibrate as jrec
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro_torch import api as tapi
from repro_torch.core import variation as tvar
from repro_torch.eval import recalibrate as rec
from repro_torch.interop import from_numpy_tree
from repro_torch.models import whisper as t_whisper
from repro_torch.models.registry import get_model
from repro_torch.serve import health as th
from repro_torch.serve.engine import ServingEngine, engine_from_artifact
from test_torch_serve_drift import SCHED

CPU = "cpu"
ARCH = "whisper-small"
B, MAX_LEN, PROBES, T = 2, 32, 8, 400


@pytest.fixture(scope="module")
def served():
    """The JAX package's pack of the reduced whisper as a port artifact,
    the port's encoder states of numpy frames, and the prompts."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    jmodel = j_get_model(jcfg)
    packed = jax.jit(lambda k: japi.pack_model(
        j_init_params(jmodel.specs(jcfg), k), jcfg.cim))(
        jax.random.PRNGKey(0))
    tart = tapi.DeployArtifact(
        kind="model", config=tcfg.cim.replace(mode="deploy"),
        params=from_numpy_tree(jax.tree.map(np.asarray, packed), CPU))
    enc = t_whisper.encode(tart.params,
                           torch.from_numpy(zoo.frontend_input(tcfg)),
                           tcfg.replace(cim=tart.config))
    prompts = np.random.default_rng(4).integers(
        0, tcfg.vocab, (B, 3)).astype(np.int32)
    return {"artifact": tart, "cfg": tcfg, "enc": enc, "prompts": prompts}


def test_generate_batch_takes_the_callers_encoder_states(served):
    tart, tcfg, enc = served["artifact"], served["cfg"], served["enc"]

    def engine(batch):
        return engine_from_artifact(tart, tcfg, batch_size=batch,
                                    max_len=MAX_LEN, device=CPU)
    with pytest.raises(ValueError, match="enc_out"):
        engine(B).generate_batch(served["prompts"], 3)
    half = _with_states(engine(B), enc[:1])
    with pytest.raises(ValueError, match="1 requests"):
        half.generate_batch(served["prompts"], 3)
    one = served["prompts"][:1]
    batch = _with_states(engine(1), enc[:1]).generate_batch(one, zoo.NEW + 1)
    slots = zoo.slot_run_with_encoder(engine(1), one, enc[:1])
    np.testing.assert_array_equal(batch[:, 1:], slots)
    # in place, as a caller may write the states into the blank buffer
    inplace = engine(1)
    inplace.cache["enc_out"].copy_(enc[:1])
    np.testing.assert_array_equal(inplace.generate_batch(one, zoo.NEW + 1),
                                  batch)


def _probe_codes(key, params):
    """The reference's per-node Rademacher probes (``path_fold_key``), as
    numpy, by '/'-joined node path."""
    codes = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "w_digits" in node:
                planes = rec._row_flat(node["w_digits"])
                codes["/".join(path)] = np.asarray(jax.random.rademacher(
                    jvar.path_fold_key(key, path),
                    (PROBES, planes.shape[-3], planes.shape[-2]),
                    jnp.float32))
                return
            for k, v in node.items():
                walk(v, path + (k,))
    walk(params, ())
    return codes


def test_gains_and_corrected_scales_match_the_reference(served):
    pristine = served["artifact"].params
    obs = tvar.drift_tree(pristine, tvar.Sampler(7),
                          tvar.DriftSchedule(**SCHED).at(T))
    codes = _probe_codes(jax.random.PRNGKey(9), pristine)
    got = rec.fit_scale_delta(pristine, obs, codes=codes)
    j_pristine, j_obs = (jax.tree.map(lambda v: jnp.asarray(v.numpy()), t)
                         for t in (pristine, obs))
    want = jrec.fit_scale_delta(j_pristine, j_obs, codes=codes)
    assert set(got.gains) == set(want.gains)
    assert {"frontend/conv1", "frontend/conv2"} <= set(got.gains)
    assert got.gains["enc_layers/attn/wq"].ndim == 4     # (L, S, kt, N)
    for name, g in want.gains.items():
        np.testing.assert_allclose(got.gains[name].numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-6)
    j_app = jax.tree.map(np.asarray, jrec.apply_scale_delta_params(
        j_pristine, want))
    t_app = rec.apply_scale_delta_params(pristine, got)
    for name in want.gains:
        jn, tn = j_app, t_app
        for part in name.split("/"):
            jn, tn = jn[part], tn[part]
        for leaf in ("s_p", "deq_scale"):
            np.testing.assert_allclose(tn[leaf].numpy(), jn[leaf],
                                       rtol=1e-5, atol=1e-7)


def _with_states(engine, enc):
    engine.cache["enc_out"] = enc
    return engine


def test_hard_drift_falls_back_and_recalibration_clears_it(served):
    tart, tcfg = served["artifact"], served["cfg"]
    eng = _with_states(engine_from_artifact(
        tart, tcfg, batch_size=B, max_len=MAX_LEN, device=CPU,
        drift_key=tvar.Sampler(7), drift_schedule=tvar.DriftSchedule(**SCHED),
        health=th.DriftMonitor(th.HealthConfig(
            warmup=2, soft_threshold=0.0, hard_threshold=0.0))),
        served["enc"])
    eng.t = T
    eng.generate_batch(served["prompts"], 5)
    h = eng.health()
    assert h["fallback_active"] and h["hard_events"] == 1
    # the slot engine on the fallback: every invocation on the ref backend
    # and the pristine planes, as a ref-backend engine serves them
    fb = zoo.slot_run_with_encoder(eng, served["prompts"], served["enc"])
    ref_eng = ServingEngine(get_model(eng.cfg), eng.cfg.replace(
        cim=tart.config.replace(mode="ref")), tart.params, batch_size=B,
        max_len=MAX_LEN, device=CPU)
    np.testing.assert_array_equal(
        fb, zoo.slot_run_with_encoder(ref_eng, served["prompts"],
                                      served["enc"]))
    eng.recalibrate(probes=PROBES)
    h = eng.health()
    assert not h["fallback_active"] and h["recalibrations"] == 1
    assert "deq_scale" in eng.params["frontend"]["conv1"]
    assert eng.params["enc_layers"]["attn"]["wq"]["deq_scale"].ndim == 4
