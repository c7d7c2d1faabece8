"""Cell variation baked into a pack, on the port against the JAX package,
on the CPU: ``repro_torch.api.pack_model`` / ``model_artifact`` with a
variation source and a sigma against ``repro.api.pack_model`` /
``model_artifact`` with ``variation_key`` and ``variation_std``, on the
same params (initialised by the JAX package, carried across as numpy).

The source is ``_torch_drift_source.JaxDriftSource``: a node's theta is
``jax.random.normal`` of its ``path_fold_key`` (the reference's
``_path_key``), a stacked node's layer ``i`` and a bank's slice ``i`` take
the ``i``-th of ``jax.random.split`` of the node's key. The nodes: plain
and stacked linears (zamba2's shared block, its Mamba2 stack), convs and
stacked linears (whisper's stem, its encoder and decoder stacks), MoE
banks and stacked linears (moonshot), and a stacked conv (5-D ``w``,
made from whisper's stem). Integer leaves (occupancy maps, ``k_logical``)
are equal; the float32 planes ``d * exp(sigma * theta)`` at 1e-6 relative
(theta is the reference's own; ``exp`` may differ by an ulp); scales
pass through unchanged; ``meta["col_shard"]`` is the reference's.

Within the port: deploy on a baked whisper pack equals emulate under the
same per-node sources bit for bit (``chip_smoke._varied_emulate``, phase
15's interceptor), the int4 pack bakes its nibble planes over the logical
layout, and the port's ``Sampler`` draws independent layers and repeats
itself.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from _torch_drift_source import JaxDriftSource
from repro import api as japi
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro_torch import api as tapi
from repro_torch.core.variation import Sampler
from repro_torch.interop import from_numpy_tree
from repro_torch.models.registry import get_model

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CPU = "cpu"
SIGMA = 0.3
KEY = 5


def _params(arch, **kw):
    jcfg, tcfg = zoo.cfgs(arch, **kw)
    jmodel = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(jmodel.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, params)


def _stacked_conv(params):
    """A tree with whisper's first stem conv stacked twice (the second
    scaled): a 5-D ``w`` with per-layer scales."""
    conv = params["frontend"]["conv1"]
    return {"convs": {k: np.stack([v, v * (0.5 if k == "w" else 1.0)])
                      for k, v in conv.items()}}


def _packs(jcfg, tcfg, params, **kw):
    key = jax.random.PRNGKey(KEY)
    want = jax.jit(lambda p: japi.pack_model(
        p, jcfg.cim, variation_key=key, variation_std=SIGMA, **kw))(params)
    got = tapi.pack_model(from_numpy_tree(params, CPU), tcfg.cim,
                          variation=JaxDriftSource(key),
                          variation_std=SIGMA, device=CPU)
    return jax.tree.map(np.asarray, want), got


def _compare(want, got, path=""):
    """Every leaf of the reference's pack against the port's; returns the
    '/'-joined paths of the float32 digit planes compared."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        planes = []
        for k in want:
            planes += _compare(want[k], got[k], f"{path}/{k}")
        return planes
    g = got.numpy()
    if want.dtype.name == "int4":
        want = want.astype(np.int8)
    assert g.shape == want.shape and g.dtype == want.dtype, path
    if path.endswith("_digits"):
        assert want.dtype == np.float32, path
        np.testing.assert_allclose(g, want, rtol=1e-6, atol=0, err_msg=path)
        return [path]
    np.testing.assert_array_equal(g, want, err_msg=path)
    return []


@pytest.mark.parametrize("arch,kinds", [
    ("zamba2-2.7b", ("shared_attn/attn/wq/w_digits",
                     "mamba_layers/in_proj/w_digits")),
    ("whisper-small", ("frontend/conv1/w_digits",
                       "enc_layers/attn/wq/w_digits")),
    ("moonshot-v1-16b-a3b", ("moe_layers/moe/wg_digits",
                             "dense_layers/attn/wq/w_digits"))])
def test_baked_pack_equals_the_references(arch, kinds):
    jcfg, tcfg, params = _params(arch)
    want, got = _packs(jcfg, tcfg, params)
    planes = _compare(want, got)
    for k in kinds:
        assert "/" + k in planes
    # the noise landed: the planes are no longer the clean integers
    clean = tapi.pack_model(from_numpy_tree(params, CPU), tcfg.cim,
                            device=CPU)
    node = clean
    for part in kinds[0].split("/"):
        node = node[part]
    baked = got
    for part in kinds[0].split("/"):
        baked = baked[part]
    assert not torch.equal(baked, node.to(torch.float32))


def test_baked_stacked_conv_equals_the_references():
    jcfg, tcfg, params = _params("whisper-small")
    tree = _stacked_conv(params)
    want, got = _packs(jcfg, tcfg, tree)
    assert got["convs"]["w_digits"].ndim == 7
    assert _compare(want, got) == ["/convs/w_digits"]
    # the two layers drew different fields
    d = got["convs"]["w_digits"]
    ratio = d[1] / torch.where(d[0] == 0, torch.ones_like(d[0]), d[0])
    assert ratio[d[0] != 0].std() > 0


def test_baked_model_artifact_equals_the_references():
    """``model_artifact`` with a source: the reference's planes (its
    ``pack_model`` with the key, jitted), its ``col_shard`` map, the
    config pinned to deploy."""
    from repro.api.artifact import col_shard_axes
    jcfg, tcfg, params = _params("zamba2-2.7b")
    want, _ = _packs(jcfg, tcfg, params)
    tart = tapi.model_artifact(from_numpy_tree(params, CPU), tcfg.cim,
                               variation=JaxDriftSource(
                                   jax.random.PRNGKey(KEY)),
                               variation_std=SIGMA, device=CPU)
    assert tart.meta["col_shard"] == col_shard_axes(want)
    assert tart.config == tcfg.cim.replace(mode="deploy")
    _compare(want, tart.params)


def test_int4_bakes_the_logical_planes():
    """int4 packs nibble their planes; a baked int4 pack draws over the
    logical (unpacked) planes, as the reference's, and keeps the clean
    occupancy map."""
    jcfg, tcfg, params = _params("qwen3-0.6b", pack_dtype="int4")
    want, got = _packs(jcfg, tcfg, params)
    planes = _compare(want, got)
    assert planes
    clean = tapi.pack_model(from_numpy_tree(params, CPU), tcfg.cim,
                            device=CPU)
    wq = clean["layers"]["attn"]["wq"]
    assert wq["w_digits"].dtype == torch.uint8
    baked = got["layers"]["attn"]["wq"]
    assert baked["w_digits"].shape[-2] == 2 * wq["w_digits"].shape[-2]
    assert torch.equal(baked["w_occ"], wq["w_occ"])


def test_baked_deploy_equals_emulate_under_the_same_sources():
    """whisper with its conv stem: the forward on a pack baked from a
    ``Sampler`` equals emulate whose every CIM linear and conv draws the
    same node's theta (a stacked layer its slice of ``split``) at the
    same sigma, bit for bit; the same source bakes the same pack."""
    _, tcfg, params = _params("whisper-small")
    params = from_numpy_tree(params, CPU)
    src = Sampler(11)
    art = tapi.model_artifact(params, tcfg.cim, variation=src,
                              variation_std=SIGMA, device=CPU)
    again = tapi.pack_model(params, tcfg.cim, variation=Sampler(11),
                            variation_std=SIGMA, device=CPU)
    assert torch.equal(again["enc_layers"]["attn"]["wq"]["w_digits"],
                       art.params["enc_layers"]["attn"]["wq"]["w_digits"])
    stacked = art.params["enc_layers"]["attn"]["wq"]["w_digits"]
    assert not torch.equal(stacked[0], stacked[1])
    model = get_model(tcfg)
    tokens = torch.from_numpy(np.array(np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, 5)), np.int32))
    extra = torch.from_numpy(zoo.frontend_input(tcfg))
    dp = model.forward(art.params, tokens, tcfg.replace(cim=art.config),
                       extra)
    with chip_smoke._varied_emulate(art.params, params, src, SIGMA) as em:
        ep = model.forward(params, tokens, tcfg, extra)
    (k1, k3), _ = chip_smoke.recurrent_zoo_counts(tcfg)
    assert em.hits == k1 + k3
    assert float((dp - ep).abs().max()) == 0.0
