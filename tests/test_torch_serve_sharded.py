"""Column-parallel serving on the port (DESIGN.md §10) on four gloo ranks
on the CPU, against the single-device port and the JAX package's engine:
the counterparts of ``tests/test_serve_sharded.py``'s artifact and engine
cases.

The reduced qwen3-0.6b with 32x32 arrays in float32 is initialised and
packed by the JAX package (the reference test's ``_lm_artifact``) and
saved by it; every rank loads that directory unsharded and with
``mesh=`` (``DeployArtifact.load``). Bit for bit, sharded == single
device: placements (divisible nodes sharded, ragged ones whole, values
unchanged), the files of a sharded save, model logits, engine tokens
greedy and sampled (also equal to the JAX engine's greedy tokens, and on
every rank), drifted logits and drifted engine tokens, a ``ScaleDelta``
applied to both placements, and the reduced moonshot, whose packed banks
go expert by expert through the sharded dispatch under a mesh (the
experts kernel gated off). The expert-parallel MoE and flash decode are
``tests/test_torch_parallel_layers.py``'s. The ranks spawn once for the
file (120 s limit).
"""
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from repro import api as japi
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.serve.engine import engine_from_artifact as j_engine_from_artifact

WORLD = 4


def jax_lm_artifact():
    """The reference test's ``_lm_artifact``: (artifact, config)."""
    cim = JCIMConfig(**R.CIM, use_kernel=False)
    cfg = j_get_config(R.LM_ARCH, reduced=True, cim=cim).replace(
        compute_dtype="float32")
    params = jax.jit(lambda k: j_init_params(
        j_get_model(cfg).specs(cfg), k))(jax.random.PRNGKey(0))
    return japi.model_artifact(params, cim), cfg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_sharded")
    art, cfg = jax_lm_artifact()
    art.save(str(out / "jax_artifact"))
    prompts = R.lm_inputs(cfg.vocab)[1]
    jtok = j_engine_from_artifact(art, cfg, batch_size=2,
                                  max_len=64).generate_batch(prompts, 6)
    res = R.run_ranks(R.serve_body, WORLD, str(out))
    return dict(out=out, ranks=res, jax_tokens=np.asarray(jtok),
                col_shard=art.meta["col_shard"])


def _equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _triples(ranks, key):
    for res in ranks["ranks"]:
        single, on_full, on_shards = res[key]
        _equal(on_full, single)
        _equal(on_shards, single)


def test_load_places_divisible_nodes_sharded(ranks):
    for res in ranks["ranks"]:
        place = res["placements"]
        assert set(place) == set(ranks["col_shard"])
        for name, (n, sharded, same) in place.items():
            assert sharded == (n % WORLD == 0), name
            assert same, name
        assert any(s for _, s, _ in place.values())


def test_sharded_save_writes_the_unsharded_files(ranks):
    a, b = ranks["out"] / "saved_single", ranks["out"] / "saved_sharded"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for root, _, files in os.walk(a):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), a)
            assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


def test_model_logits_sharded_equal_single(ranks):
    _triples(ranks, "logits")


@pytest.mark.parametrize("key", ["tokens", "sampled", "drift_tokens"])
def test_engine_tokens_sharded_equal_single(ranks, key):
    want = ranks["ranks"][0][key][0]
    for res in ranks["ranks"]:
        single, sharded, devices = res[key]
        _equal(single, want)
        _equal(sharded, want)            # the same on every rank
        assert devices == WORLD
    if key == "tokens":
        _equal(want, ranks["jax_tokens"])


def test_drifted_logits_sharded_equal_single(ranks):
    _triples(ranks, "drift_logits")


def test_scale_delta_on_a_sharded_artifact(ranks):
    for res in ranks["ranks"]:
        leaves, applied, version = res["recal"]
        assert applied == version
        for name, per in leaves.items():
            for leaf, (single, sharded, placed) in per.items():
                _equal(sharded, single)
                n = single.shape[-1]
                if leaf == "deq_scale":
                    assert placed == (n % WORLD == 0), name
    _triples(ranks, "recal_logits")


def test_moe_banks_per_expert_under_a_mesh(ranks):
    for res in ranks["ranks"]:
        single, sharded, k6_single, k6_sharded, gathers, banks = res["moe"]
        _equal(sharded.float(), single.float())
        assert k6_single > 0 and k6_sharded == 0
        assert gathers > 0 and banks > 0


def test_a_mesh_of_one_rank_is_unsharded():
    from repro_torch.core import colshard
    assert colshard.mesh_shards(None, "model") == 1
    with pytest.raises(TypeError, match="DeviceMesh"):
        colshard.check_mesh(object(), "model")
    assert not colshard.is_col_sharded(torch.zeros(2))
