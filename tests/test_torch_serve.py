"""Serving on the port against the JAX package's engine, on the CPU: the
reduced moonshot-v1-16b-a3b packed into one in-memory ``DeployArtifact``
by the JAX package, served by both engines from the same bytes.

Greedy tokens must be identical: lockstep ``generate_batch``, and the
slot engine's ``submit``/``step`` over three requests of mixed lengths
at batch 2 (whose token-by-token prefill advances every slot's cache, as
the reference's does). Entry points default to ``cuda`` and raise on a
machine without one.
"""
import jax
import numpy as np
import pytest

from repro import api as japi
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.serve.engine import engine_from_artifact as j_engine_from_artifact
from repro_torch import api as tapi
from repro_torch.configs.registry import get_config
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.serve.engine import ServingEngine, engine_from_artifact

CPU = "cpu"
ARCH = "moonshot-v1-16b-a3b"
CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
           act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
REQUESTS = (([3, 5, 7], 4), ([11, 13], 2), ([2], 3))


def _slot_run(engine):
    rids = [engine.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    done = {}
    for _ in range(30):
        for fin in engine.step():
            done[fin["rid"]] = list(fin["tokens"])
        if len(done) == len(rids):
            break
    return [done.get(r) for r in rids]


@pytest.fixture(scope="module")
def served():
    """The JAX package's artifact and its engine's tokens, both runs on one
    engine (its jitted steps compile once)."""
    jcfg = j_get_config(ARCH, reduced=True, cim=JCIMConfig(**CIM)).replace(
        compute_dtype="float32", remat=False)
    params = jax.jit(lambda k: j_init_params(
        j_get_model(jcfg).specs(jcfg), k))(jax.random.PRNGKey(0))
    art = japi.model_artifact(params, jcfg.cim)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 6), 0,
                                            jcfg.vocab), np.int32)
    eng = j_engine_from_artifact(art, jcfg, batch_size=2, max_len=32)
    return {"artifact": art, "prompts": prompts,
            "batch": eng.generate_batch(prompts, 5),
            "slots": _slot_run(eng), "params": jax.tree.map(np.asarray, params)}


def _port_artifact(served):
    """The JAX-packed bytes as a port ``DeployArtifact``, and the config."""
    art = served["artifact"]
    tcfg = get_config(ARCH, reduced=True, cim=TCIMConfig(**CIM)).replace(
        compute_dtype="float32", remat=False)
    params = from_numpy_tree(jax.tree.map(np.asarray, art.params), CPU)
    return (tapi.DeployArtifact(kind="model", config=TCIMConfig(
        **CIM).replace(mode="deploy"), params=params, meta=dict(art.meta)),
        tcfg)


def test_generate_batch_matches_reference_engine(served):
    art, tcfg = _port_artifact(served)
    eng = engine_from_artifact(art, tcfg, batch_size=2, max_len=32,
                               device=CPU)
    assert eng.cfg.cim.mode == "deploy"
    out = eng.generate_batch(served["prompts"], 5)
    assert out.shape == (2, 5) and out.dtype == np.int32
    np.testing.assert_array_equal(out, served["batch"])


def test_slot_engine_matches_reference_engine(served):
    art, tcfg = _port_artifact(served)
    eng = engine_from_artifact(art, tcfg, batch_size=2, max_len=32,
                               device=CPU)
    got = _slot_run(eng)
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    assert got == served["slots"]
    assert eng.retired == 3 and not eng.queue


def test_port_packed_artifact_serves_the_same_tokens(served):
    """The port's own pack of the same params serves the same tokens."""
    _, tcfg = _port_artifact(served)
    art = tapi.model_artifact(from_numpy_tree(served["params"], CPU),
                              tcfg.cim, device=CPU)
    eng = engine_from_artifact(art, tcfg, batch_size=2, max_len=32,
                               device=CPU)
    np.testing.assert_array_equal(eng.generate_batch(served["prompts"], 5),
                                  served["batch"])


def test_temperature_sampling_is_seeded(served):
    art, tcfg = _port_artifact(served)
    runs = [engine_from_artifact(art, tcfg, batch_size=2, max_len=32,
                                 temperature=1.0, seed=s, device=CPU
                                 ).generate_batch(served["prompts"], 6)
            for s in (7, 7)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert runs[0].min() >= 0 and runs[0].max() < tcfg.vocab


def test_entry_points_default_to_cuda_and_refuse_unported_keywords(served):
    art, tcfg = _port_artifact(served)
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine_from_artifact(art, tcfg, batch_size=2, max_len=32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.model_artifact(art.params, art.config)
    # column-parallel serving is ported (tests/test_torch_serve_sharded.py):
    # a mesh is a DeviceMesh, and the engine itself takes no mesh keyword
    with pytest.raises(TypeError, match="DeviceMesh"):
        engine_from_artifact(art, tcfg, batch_size=2, max_len=32,
                             mesh=object(), device=CPU)
    with pytest.raises(TypeError):
        ServingEngine(None, tcfg, art.params, mesh=object(), device=CPU)
    with pytest.raises(TypeError):
        ServingEngine(None, tcfg, art.params, bogus=1, device=CPU)
