"""Shared parts of the zoo-on-a-drifting-chip parity tests against the
JAX package (``tests/test_torch_zoo_drift.py`` for whisper and llava,
``tests/test_torch_zoo_drift_recurrent.py`` for zamba2 and xlstm): each
family at its reduced config (``tests/_torch_zoo.py``'s parity CIM
config, float32), packed by the JAX package into one ``DeployArtifact``
and served by both engines from the same bytes, drifting under
``tests/test_drift.py``'s schedule from ``t = 300`` with the JAX
package's own fields (``_torch_drift_source.JaxDriftSource``).

The checks: the port's ``drift_tree`` drifts the nodes the reference's
drifts, with its fields; the drifting engine's ``generate_batch`` gives the
reference's tokens, and every invocation's logits (the engine's drifted
prefill function, one realization per ``t``) agree at 1e-4 (the fields at
1e-6, ``exp`` aside); whisper decodes against the encoder states of its
log-mel frames in both caches (the port's repaired ``generate_batch``;
the reference's lockstep function driven with the states in its cache,
since its ``generate_batch`` drops them: ROADMAP fault 13), and its
drifting slot engines agree too. Within the port, the drifted deploy
forward with the front-end input equals drifted emulate under the same
fields bit for bit, the convs' included (``chip_smoke._drifted_emulate``,
phase 15's interceptor).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_zoo as zoo
from _torch_drift_source import JaxDriftSource
from repro.core import variation as jvar
from repro.models import whisper as j_whisper
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.serve.engine import engine_from_artifact as j_engine_from_artifact
from repro_torch import api as tapi
from repro_torch.core import variation as tvar
from repro_torch.interop import from_numpy_tree
from repro_torch.models import whisper as t_whisper
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import engine_from_artifact
from test_torch_serve_drift import SCHED, T0, _j_artifact

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CPU = "cpu"
#: one-token prompts: every invocation, prefill or decode step, has one
#: shape, so the reference's drifted step compiles once
B, TP, NEW, MAX_LEN = 2, 1, 3, 32


def make_reference(arch):
    """The JAX side of one family: its artifact, the prompts, and the
    drifting engine's invocations one after the other from T0 (the
    engine's own jitted drifted prefill function): last-position logits
    and greedy tokens; whisper's also its drifting slot engine's tokens,
    the encoder states in its cache."""
    jcfg, _ = zoo.cfgs(arch)
    jmodel = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(jmodel.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    art = _j_artifact(params, jcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (B, TP),
                                            0, jcfg.vocab), np.int32)
    extra = zoo.frontend_input(jcfg)
    dkey = jax.random.PRNGKey(7)
    eng = j_engine_from_artifact(art, jcfg, batch_size=B, max_len=MAX_LEN,
                                 drift_key=dkey,
                                 drift_schedule=jvar.DriftSchedule(**SCHED))
    out = {"arch": arch, "artifact": art, "params": params,
           "prompts": prompts, "extra": extra, "key": dkey}
    cache = jmodel.init_cache(jcfg.replace(cim=art.config), B, MAX_LEN)
    if jcfg.family == "whisper":
        dcfg = jcfg.replace(cim=art.config)
        # numpy: the engine's jitted step donates the cache it is given
        out["enc"] = np.asarray(jax.jit(
            lambda p, e: j_whisper.encode(p, e, dcfg))(art.params,
                                                       jnp.asarray(extra)))
        cache["enc_out"] = jnp.asarray(out["enc"])
        eng.t = T0
        out["slots"] = zoo.slot_run_with_encoder(eng, prompts,
                                                 jnp.asarray(out["enc"]))
    tok, logits, tokens = jnp.asarray(prompts), [], []
    for i in range(NEW):
        lg, cache = eng._prefill_fn(art.params, cache, tok, jnp.int32(T0 + i))
        logits.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        tokens.append(np.asarray(tok))
    out["logits"], out["tokens"] = logits, np.concatenate(tokens, axis=1)
    return out


def make_port(ref):
    """The reference's artifact as a port ``DeployArtifact``, its config,
    and whisper's encoder states of the same frames on the port."""
    art = ref["artifact"]
    _, tcfg = zoo.cfgs(ref["arch"])
    tart = tapi.DeployArtifact(
        kind="model", config=tcfg.cim.replace(mode="deploy"),
        params=from_numpy_tree(jax.tree.map(np.asarray, art.params), CPU),
        meta=dict(art.meta))
    enc = None
    if tcfg.family == "whisper":
        enc = t_whisper.encode(tart.params, torch.from_numpy(ref["extra"]),
                               tcfg.replace(cim=tart.config))
        np.testing.assert_allclose(enc.numpy(), ref["enc"], **zoo.LOGIT_TOL)
    return {"artifact": tart, "cfg": tcfg, "enc": enc}


def engine(port, batch=B, **kw):
    """The port's engine on the artifact, whisper's encoder states (of the
    first ``batch`` requests) in its cache."""
    eng = engine_from_artifact(port["artifact"], port["cfg"],
                               batch_size=batch, max_len=MAX_LEN, device=CPU,
                               **kw)
    if port["enc"] is not None:
        eng.cache["enc_out"] = port["enc"][:batch]
    return eng


def drifting(port, ref, **kw):
    eng = engine(port, drift_key=JaxDriftSource(ref["key"]),
                 drift_schedule=tvar.DriftSchedule(**SCHED), **kw)
    eng.t = T0
    return eng


def check_engine_tokens(port, ref):
    """``generate_batch`` on the drifting chip (whisper's repaired one,
    against the reference's lockstep run with the states in its cache),
    and whisper's drifting slot engine against the reference's."""
    eng = drifting(port, ref)
    out = eng.generate_batch(ref["prompts"], NEW)
    np.testing.assert_array_equal(out, ref["tokens"])
    assert eng.t == T0 + NEW and eng.health()["drifting"]
    if "slots" in ref:
        slot = drifting(port, ref)
        np.testing.assert_array_equal(
            zoo.slot_run_with_encoder(slot, ref["prompts"], port["enc"]),
            ref["slots"])


def check_logits_per_invocation(port, ref):
    """Each invocation from T0 on its own drift realization, through the
    port engine's drifted prefill function: last-position logits at 1e-4
    of the reference's, no near-tie deciding a token."""
    eng = drifting(port, ref)
    model = get_model(eng.cfg)
    cache = model.init_cache(eng.cfg, B, MAX_LEN, device=CPU)
    if port["enc"] is not None:
        cache["enc_out"] = port["enc"]
    tok = torch.from_numpy(np.array(ref["prompts"]))
    for i, want in enumerate(ref["logits"]):
        lg, cache = eng._prefill_fn(eng.params, cache, tok, T0 + i)
        last = lg[:, -1].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(last, want, rtol=1e-4, atol=1e-4 * scale)
        top2 = np.sort(last, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 1e-3 * scale)
        tok = torch.from_numpy(np.array(ref["tokens"][:, i:i + 1]))


def check_drift_tree_reaches_the_references_nodes(port, ref):
    """The port's ``drift_tree`` on the reference's pack at T0 drifts the
    nodes the reference's does (``jax.eval_shape`` of it: every leaf's
    shape and dtype, float32 planes where a node drifts): the front-end
    convs, zamba2's shared block and the stacked layers among them. The
    fields' values are held by the logits checks. Returns the drifted
    planes' '/'-joined paths."""
    st = jvar.DriftSchedule(**SCHED).at(T0)
    want = jax.eval_shape(lambda p: jvar.drift_tree(p, ref["key"], st),
                          ref["artifact"].params)
    got = tvar.drift_tree(port["artifact"].params, JaxDriftSource(ref["key"]),
                          tvar.DriftSchedule(**SCHED).at(T0))
    drifted = []

    def walk(w, g, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                walk(w[k], g[k], f"{path}/{k}")
            return
        dtype = np.dtype(np.int8 if w.dtype.name == "int4" else w.dtype)
        assert (tuple(g.shape), g.numpy().dtype) == (tuple(w.shape),
                                                     dtype), path
        if path.endswith("/w_digits") and dtype == np.float32:
            drifted.append(path)
    walk(want, got, "")
    assert len(drifted) == sum(1 for _ in chip_smoke._packed_nodes(got))
    return drifted


def check_deploy_equals_emulate(port, ref):
    """Within the port: the forward with the front-end input on the
    drifted packed tree equals the emulate forward whose every CIM linear
    and conv draws the same node's fields (max difference 0.0), and the
    drift moved it from the clean forward."""
    tcfg, tart = port["cfg"], port["artifact"]
    model = get_model(tcfg)
    params = from_numpy_tree(jax.tree.map(np.asarray, ref["params"]), CPU)
    tokens = torch.from_numpy(np.array(ref["prompts"]))
    extra = zoo._extra(ref)
    src = JaxDriftSource(ref["key"])
    st = tvar.DriftSchedule(**SCHED).at(T0)
    dcfg = tcfg.replace(cim=tart.config)
    dp = model.forward(tvar.drift_tree(tart.params, src, st), tokens, dcfg,
                       extra)
    with chip_smoke._drifted_emulate(tart.params, params, src, st,
                                     {}) as em:
        ep = model.forward(params, tokens, tcfg, extra)
    (k1, k3), _ = chip_smoke.recurrent_zoo_counts(tcfg)
    assert em.hits == k1 + k3
    assert float((dp - ep).abs().max()) == 0.0
    clean = model.forward(tart.params, tokens, dcfg, extra)
    assert float((clean - dp).abs().max()) > 0.0
