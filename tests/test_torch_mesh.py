"""The port's mesh layer (``launch.mesh``, the session mesh of
``nn.module``) against the reference's, the sharded serving launcher on
the CPU, and the port's 4-rank logits against the reference's 4-device
sharded logits.

``resolve_pspec`` and ``sharding_rules`` equal the reference's functions;
``session_mesh`` restores the previous mesh, and an engine raises when
the session mesh changed since it was built. ``launch.serve.main`` with
``--mesh 4 --device cpu --dist-backend gloo`` spawns four gloo ranks and
prints ``--mesh 1``'s tokens; ``nccl`` without a card per rank raises.
The reference's own sharded tests skip in this run (one host device), so
one subprocess runs the reference's sharded path under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on the JAX
package's reduced qwen3 artifact (``use_kernel=False``, as its test
does), and its 4-device logits and tokens are held against the port's
4-rank ones at the tolerance the port's unsharded logits are held to
against JAX (rtol / atol 1e-4, ``tests/_torch_zoo.py``), tokens
identical.
"""
import contextlib
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from repro import api as japi
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.launch import mesh as jmesh
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.nn import module as jmod
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as t_serve
from repro_torch.nn import module as tmod

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
RULES = {"batch": ("pod", "data"), "heads": "model", "mlp": "model",
         "embed": None, "experts": ("model",), "vocab": "model"}


@pytest.mark.parametrize("logical", [
    ("embed", "heads"),                 # basic
    ("heads", "mlp"),                   # a mesh axis appears at most once
    ("batch", None, "heads", None),     # trailing Nones trimmed
    ("experts", "vocab", "embed"),
    (None, None),
    None,
])
def test_resolve_pspec_matches_the_reference(logical):
    want = tuple(jmod.resolve_pspec(logical, RULES))
    assert tmod.resolve_pspec(logical, RULES) == want


@pytest.mark.parametrize("axes", [("model",), ("data", "model"),
                                  ("pod", "data", "model"), ("data",)])
@pytest.mark.parametrize("fsdp", [False, True])
def test_sharding_rules_match_the_reference(axes, fsdp):
    jm = jax.make_mesh((1,) * len(axes), axes)
    tm = types.SimpleNamespace(mesh_dim_names=axes)
    assert tmesh.sharding_rules(tm, fsdp=fsdp) == jmesh.sharding_rules(
        jm, fsdp=fsdp)
    assert tmesh.batch_axes(tm) == jmesh.batch_axes(jm)


def test_session_mesh_restores_the_previous_mesh():
    a, b = object(), object()
    tmod.set_activation_rules({"heads": "model"}, a)
    try:
        with tmod.session_mesh(b) as m:
            assert m is b and tmod.current_mesh() is b
            assert tmod.current_rules() == {"heads": "model"}
            with tmod.session_mesh(None, {}):
                assert tmod.current_mesh() is None
                assert tmod.current_rules() == {}
            assert tmod.current_mesh() is b
        assert tmod.current_mesh() is a
    finally:
        tmod.set_activation_rules(None, None)
    assert tmod.current_mesh() is None


def test_engine_raises_when_the_session_mesh_changed():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import ServingEngine
    cfg = get_config(R.LM_ARCH, reduced=True).replace(
        compute_dtype="float32", remat=False)
    model = get_model(cfg)
    params = tmod.init_params(model.specs(cfg), 0, device="cpu")
    prompts = R.lm_inputs(cfg.vocab)[1]
    built_under = object()
    with tmod.session_mesh(built_under):
        eng = ServingEngine(model, cfg, params, batch_size=2, max_len=32,
                            device="cpu")
        assert eng.health()["mesh"] == repr(built_under)
        assert eng.generate_batch(prompts, 2).shape == (2, 2)
    with pytest.raises(RuntimeError, match="session mesh changed"):
        eng.generate_batch(prompts, 2)
    with pytest.raises(RuntimeError, match="session mesh changed"):
        eng.step()


def _launch(capfd, *flags):
    argv = ["--arch", R.LM_ARCH, "--reduced", "--cim", "deploy", "--batch",
            "2", "--prompt-len", "8", "--new-tokens", "6", "--device", "cpu",
            *flags]
    assert t_serve.main(argv) == 0
    out = capfd.readouterr().out.splitlines()
    return [ln for ln in out if ln.startswith("[serve]")]


def test_launcher_mesh_4_prints_mesh_1_tokens(capfd):
    four = _launch(capfd, "--mesh", "4", "--dist-backend", "gloo")
    one = _launch(capfd, "--mesh", "1")
    pick = lambda lines, what: [ln for ln in lines if what in ln]  # noqa
    assert len(pick(four, "sample continuation")) == 1   # rank 0 prints
    assert pick(four, "sample continuation") == pick(one,
                                                     "sample continuation")
    assert "mesh=4" in pick(four, "generated")[0]
    assert pick(four, "admission") == pick(one, "admission")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_nccl_without_a_card_per_rank_raises(device):
    if device == "cuda" and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has a card per rank")
    with pytest.raises(SystemExit, match="gloo"):
        t_serve.main(["--arch", R.LM_ARCH, "--reduced", "--cim", "deploy",
                      "--mesh", "4", "--device", device])
    with pytest.raises((ValueError, RuntimeError), match="gloo"):
        tmesh.check_backend("nccl", torch.device(device), 4)


def test_make_mesh_without_a_group_raises():
    with pytest.raises(RuntimeError, match="init_rank"):
        tmesh.make_mesh(4, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        tmesh.make_mesh(4, device="cpu", backend="mpi")


_REFERENCE_SHARDED = textwrap.dedent("""
    import dataclasses, sys
    import jax, numpy as np
    from repro.api import DeployArtifact
    from repro.configs.registry import get_config
    from repro.core.cim_linear import CIMConfig
    from repro.models.registry import get_model
    from repro.nn.module import set_activation_rules
    from repro.serve.engine import engine_from_artifact
    path, out, cim = sys.argv[1], sys.argv[2], eval(sys.argv[3])
    assert len(jax.devices()) == 4
    cfg = get_config("qwen3-0.6b", reduced=True, cim=CIMConfig(
        **cim, use_kernel=False)).replace(compute_dtype="float32")
    mesh = jax.make_mesh((4,), ("model",))
    art = DeployArtifact.load(path, mesh=mesh)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, cfg.vocab, (2, 8)).astype(np.int32)
    set_activation_rules({}, mesh)
    logits = get_model(cfg).forward(
        art.params, jax.numpy.asarray(toks),
        dataclasses.replace(cfg, cim=art.config))
    eng = engine_from_artifact(path, cfg, mesh=mesh, batch_size=2,
                               max_len=64)
    tokens = eng.generate_batch(toks, 6)
    np.savez(out, logits=np.asarray(logits), tokens=np.asarray(tokens))
""")


@pytest.fixture(scope="module")
def four_ways(tmp_path_factory):
    """(the port's 4-rank logits and tokens, the reference's 4-device
    ones) on the JAX package's reduced qwen3 artifact."""
    out = tmp_path_factory.mktemp("mesh_reference")
    cim = JCIMConfig(**R.CIM, use_kernel=False)
    cfg = j_get_config(R.LM_ARCH, reduced=True, cim=cim).replace(
        compute_dtype="float32")
    params = jax.jit(lambda k: j_init_params(
        j_get_model(cfg).specs(cfg), k))(jax.random.PRNGKey(0))
    japi.model_artifact(params, cim).save(str(out / "jax_artifact"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_SHARDED, str(out / "jax_artifact"),
         str(out / "reference.npz"), repr(R.CIM)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: ref.poll() is None and ref.kill())
        port = R.run_ranks(R.lm_body, 4, str(out))
        log = ref.communicate(timeout=240)[0]
    assert ref.returncode == 0, log[-3000:]
    return port, np.load(out / "reference.npz")


def test_port_4_ranks_match_the_reference_4_devices(four_ways):
    port, ref = four_ways
    for logits, tokens in port:
        np.testing.assert_allclose(logits.numpy(), ref["logits"], **LOGIT_TOL)
        np.testing.assert_array_equal(tokens, ref["tokens"])
