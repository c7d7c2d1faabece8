"""Self-healing serving on the port against the JAX package's engine, on
the CPU: the reduced moonshot-v1-16b-a3b packed by the JAX package into
one ``DeployArtifact``, served by both engines from the same bytes on a
drifting chip whose fields are the JAX package's own draws
(``_torch_drift_source.JaxDriftSource``).

A zero schedule serves the plain engine's tokens. The drifting engine
(``tests/test_drift.py``'s schedule from ``t = 300``) gives the JAX
engine's ``generate_batch`` and slot-engine tokens, with per-step logits
at 1e-4 (the drift fields agree at 1e-6, ``exp`` aside), and its
``health()`` matches the reference's apart from timings. The fallback,
recalibration and metrics are held in ``test_torch_serve_recovery.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_drift_source import JaxDriftSource
from repro import api as japi
from repro.configs.registry import get_config as j_get_config
from repro.core import variation as jvar
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.serve import health as jh
from repro.serve.engine import engine_from_artifact as j_engine_from_artifact
from repro_torch import api as tapi
from repro_torch.configs.registry import get_config
from repro_torch.core import variation as tvar
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.models.registry import get_model
from repro_torch.serve import health as th
from repro_torch.serve.engine import engine_from_artifact

CPU = "cpu"
ARCH = "moonshot-v1-16b-a3b"
CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
           act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
SCHED = dict(read_sigma=0.02, read_rate=0.0, cell_rate=2e-4, col_rate=1e-3)
T0 = 300
NEW = 5
REQUESTS = (([3, 5, 7], 4), ([11, 13], 2))
#: a monitor that watches and never trips
QUIET = dict(warmup=4, soft_threshold=1e9, hard_threshold=1e9)


def _slot_run(engine):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    done = {}
    for _ in range(30):
        for fin in engine.step():
            done[fin["rid"]] = list(fin["tokens"])
        if len(done) == len(rids):
            break
    return [done.get(r) for r in rids]


def _j_artifact(params, jcfg):
    """``repro.api.model_artifact`` with its pack jitted (eager packing
    costs seconds per node)."""
    packed = jax.jit(lambda p: japi.pack_model(p, jcfg.cim))(params)
    from repro.api.artifact import _packed_config, col_shard_axes
    return japi.DeployArtifact(kind="model", config=_packed_config(jcfg.cim),
                               params=packed,
                               meta={"col_shard": col_shard_axes(packed)})


@pytest.fixture(scope="module")
def ref():
    """The JAX package's artifact, and its engines' runs."""
    jcfg = j_get_config(ARCH, reduced=True, cim=JCIMConfig(**CIM)).replace(
        compute_dtype="float32", remat=False)
    jmodel = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(jmodel.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    art = _j_artifact(params, jcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 6), 0,
                                            jcfg.vocab), np.int32)
    dkey = jax.random.PRNGKey(7)
    sched = jvar.DriftSchedule(**SCHED)
    out = {"artifact": art, "prompts": prompts, "key": dkey}

    # the drifting engine, watched by a monitor that never trips
    eng = j_engine_from_artifact(art, jcfg, batch_size=2, max_len=32,
                                 drift_key=dkey, drift_schedule=sched,
                                 health=jh.DriftMonitor(jh.HealthConfig(
                                     **QUIET)))
    eng.t = T0
    out["batch"] = eng.generate_batch(prompts, NEW)
    out["slots"] = _slot_run(eng)
    out["health"] = eng.health()

    # its per-step logits, one invocation after the other, through the
    # engine's own jitted drifted forward
    cache = jmodel.init_cache(jcfg.replace(cim=art.config), 2, 32)
    tok, logits = jnp.asarray(prompts), []
    for i in range(NEW):
        lg, cache = eng._prefill_fn(art.params, cache, tok, jnp.int32(T0 + i))
        logits.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    out["logits"] = logits
    return out


@pytest.fixture(scope="module")
def port(ref):
    art = ref["artifact"]
    tcfg = get_config(ARCH, reduced=True, cim=TCIMConfig(**CIM)).replace(
        compute_dtype="float32", remat=False)
    params = from_numpy_tree(jax.tree.map(np.asarray, art.params), CPU)
    tart = tapi.DeployArtifact(kind="model", config=TCIMConfig(
        **CIM).replace(mode="deploy"), params=params, meta=dict(art.meta))
    return tart, tcfg


def _engine(port, ref, **kw):
    tart, tcfg = port
    eng = engine_from_artifact(tart, tcfg, batch_size=2, max_len=32,
                               device=CPU, **kw)
    return eng


def _drifting(port, ref, health):
    eng = _engine(port, ref, drift_key=JaxDriftSource(ref["key"]),
                  drift_schedule=tvar.DriftSchedule(**SCHED),
                  health=th.DriftMonitor(th.HealthConfig(**health)))
    eng.t = T0
    return eng


def test_zero_schedule_serves_the_plain_engines_tokens(port, ref):
    plain = _engine(port, ref).generate_batch(ref["prompts"], NEW)
    zero = _engine(port, ref, drift_key=tvar.Sampler(7),
                   drift_schedule=tvar.DriftSchedule())
    assert not zero.health()["drifting"]
    np.testing.assert_array_equal(zero.generate_batch(ref["prompts"], NEW),
                                  plain)
    assert zero.t == NEW


def test_drifting_engine_matches_the_reference(port, ref):
    eng = _drifting(port, ref, QUIET)
    assert eng.health()["drifting"]
    np.testing.assert_array_equal(eng.generate_batch(ref["prompts"], NEW),
                                  ref["batch"])
    assert eng.t == T0 + NEW
    assert _slot_run(eng) == ref["slots"]
    # health: every count and flag equal, the statistics at 1e-4
    got, want = eng.health(), dict(ref["health"])
    gstats, wstats = got.pop("stats"), want.pop("stats")
    assert got.pop("score") == pytest.approx(want.pop("score"), rel=1e-4)
    assert got == want
    assert gstats.keys() == wstats.keys() == {"logit_mean", "logit_var",
                                              "logit_margin"}
    for name, st in wstats.items():
        for k, v in st.items():
            assert gstats[name][k] == pytest.approx(v, rel=1e-4, abs=1e-4)


def test_drifted_logits_per_step(port, ref):
    """One invocation after the other from ``t = 300``, each on its own
    drift realization: logits at 1e-4 of the reference's."""
    tart, tcfg = port
    model = get_model(tcfg)
    dcfg = tcfg.replace(cim=tart.config)
    src, sched = JaxDriftSource(ref["key"]), tvar.DriftSchedule(**SCHED)
    cache = model.init_cache(dcfg, 2, 32, device=CPU)
    tok = torch.from_numpy(np.array(ref["prompts"]))
    for i, want in enumerate(ref["logits"]):
        p = tvar.drift_tree(tart.params, src, sched.at(T0 + i))
        lg, cache = model.decode_step(p, cache, tok, dcfg)
        last = lg[:, -1].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(last, want, rtol=1e-4, atol=1e-4 * scale)
        tok = torch.from_numpy(np.asarray(want.argmax(-1)[:, None],
                                          np.int32))
        # no near-tie decides a token
        top2 = np.sort(last, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 1e-3 * scale)
