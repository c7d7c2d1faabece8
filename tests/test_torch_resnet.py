"""The slice end to end: packed ResNet-20 inference on the port against
the JAX package, at a small size on the CPU.

As ``tests/test_cim_conv_deploy.py:146``: the JAX package initialises
and calibrates a small ResNet-20; ``repro_torch.interop`` carries the
params and BN state across as numpy. The port's emulate logits, its
``pack_model`` planes and its deploy logits then match the JAX package's
(logits at 1e-4, planes byte for byte), and the port's own calibrate
matches the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.data.pipeline import make_image_dataset as j_make_image_dataset
from repro.models import resnet as jres
from repro_torch import api as tapi
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.data.pipeline import make_image_dataset
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import resnet as tres

CPU = "cpu"
# paper's CIFAR-10 settings (benchmarks/common.py) on 64-row arrays, so that
# 3x3 convs hold an odd c_per_array (7, dense int4) and 1x1 convs an even
# one (64, nibble-packed)
CIM = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
           act_bits=3, psum_bits=4, array_rows=64, array_cols=64,
           act_signed=False)


def _cfgs(**kw):
    cim = dict(CIM, **kw)
    common = dict(name="tiny", depth=20, n_classes=10, widths=(8, 16), in_hw=8)
    return (jres.ResNetConfig(cim=JCIMConfig(**cim), **common),
            tres.ResNetConfig(cim=TCIMConfig(**cim), **common))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """JAX init + calibrate of a small ResNet-20 (jitted: eager JAX would
    compile every primitive), as numpy trees, plus the raw init."""
    jcfg, _ = _cfgs()
    raw, state = jax.jit(lambda k: jres.init(k, jcfg))(jax.random.PRNGKey(0))
    x, _ = make_image_dataset(hw=8, n=4, seed=1)
    params = jax.jit(lambda p, s, x_: jres.calibrate(p, s, x_, jcfg))(
        raw, state, jnp.asarray(x))
    return _np(params), _np(state), x, _np(raw)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    if want.dtype.name == "int4":
        want = want.astype(np.int8)        # the port's dense int4 storage
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_resnet20_slice_matches_reference(reference, pack_dtype):
    params, state, x, _ = reference
    jcfg, tcfg = _cfgs(pack_dtype=pack_dtype)
    tp, ts = from_numpy_tree(params, CPU), from_numpy_tree(state, CPU)
    jd = dataclasses.replace(jcfg, cim=jcfg.cim.replace(mode="ref"))

    @jax.jit
    def jax_side(p, s, x_):
        packed = japi.pack_model(p, jcfg.cim)
        return (jres.forward(p, s, x_, jcfg, train=False)[0], packed,
                jres.forward(packed, s, x_, jd, train=False)[0])

    y_je, j_packed, y_jd = jax_side(params, state, x)
    y_te, _ = tres.forward(tp, ts, x, tcfg, train=False, device=CPU)
    np.testing.assert_allclose(y_te.numpy(), np.asarray(y_je), rtol=1e-4,
                               atol=1e-4)

    t_packed = tapi.pack_model(tp, tcfg.cim, device=CPU)
    _assert_trees_equal(to_numpy_tree(t_packed), _np(j_packed))
    digits = [v["w_digits"].dtype for v in _cim_nodes(t_packed)]
    assert len(digits) == 13
    if pack_dtype == "int4":
        assert {torch.uint8, torch.int8} == set(digits)

    # y_jd is the reference's deploy arithmetic through its plain oracle:
    # its Pallas kernels are held against the port in test_torch_kernels.py
    td = dataclasses.replace(tcfg, cim=tcfg.cim.replace(mode="deploy"))
    y_td, _ = tres.forward(t_packed, ts, x, td, train=False, device=CPU)
    np.testing.assert_allclose(y_td.numpy(), np.asarray(y_jd), rtol=1e-4,
                               atol=1e-4)
    # within the port, deploy is bit-identical with emulate
    np.testing.assert_array_equal(y_td.numpy(), y_te.numpy())
    # a tree packed by the JAX package serves on the port as it is
    y_tj, _ = tres.forward(from_numpy_tree(_np(j_packed), CPU), ts, x, td,
                           train=False, device=CPU)
    np.testing.assert_array_equal(y_tj.numpy(), y_td.numpy())


def _cim_nodes(tree):
    for v in tree.values():
        if isinstance(v, dict):
            if "w_digits" in v:
                yield v
            else:
                yield from _cim_nodes(v)


def test_calibrate_and_train_bn_match_reference(reference):
    jcfg, tcfg = _cfgs()
    params, state, x, raw = reference
    got = tres.calibrate(from_numpy_tree(raw, CPU),
                         from_numpy_tree(state, CPU), x, tcfg, device=CPU)
    for name, _ in tres.conv_layer_names(tcfg):
        blk, layer = name.split(".")
        for key in ("s_a", "s_p", "s_w"):
            np.testing.assert_allclose(got[blk][layer][key].numpy(),
                                       params[blk][layer][key], rtol=1e-5,
                                       err_msg=f"{name}.{key}")
    # train-mode forward: logits and the BN running statistics
    y_j, st_j = jax.jit(lambda p, s, x_: jres.forward(
        p, s, x_, jcfg, train=True))(params, state, x)
    y_t, st_t = tres.forward(from_numpy_tree(params, CPU),
                             from_numpy_tree(state, CPU), x, tcfg, train=True,
                             device=CPU)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    got_state = dict(_leaves(to_numpy_tree(st_t)))
    want_state = dict(_leaves(_np(st_j)))
    assert set(got_state) == set(want_state)
    for path, want in want_state.items():
        np.testing.assert_allclose(got_state[path], want, rtol=1e-4,
                                   atol=1e-5, err_msg=path)


def test_port_lifecycle_on_its_own():
    """init -> calibrate -> pack_model -> deploy with the port alone."""
    _, tcfg = _cfgs(pack_dtype="int4")
    params, state = tres.init(7, tcfg, device=CPU)
    x, _ = make_image_dataset(hw=8, n=3, seed=2)
    params = tres.calibrate(params, state, x, tcfg, device=CPU)
    y_e, _ = tres.forward(params, state, x, tcfg, train=False, device=CPU)
    packed = tapi.pack_model(params, tcfg.cim, device=CPU)
    td = dataclasses.replace(tcfg, cim=tcfg.cim.replace(mode="deploy"))
    y_d, _, taps = tres.forward(packed, state, x, td, train=False,
                                return_taps=True, device=CPU)
    assert y_d.shape == (3, 10) and torch.isfinite(y_d).all()
    np.testing.assert_array_equal(y_d.numpy(), y_e.numpy())
    assert list(taps) == [n for n, _ in tres.conv_layer_names(tcfg)]
    # the same seed gives the same model
    again, _ = tres.init(7, tcfg, device=CPU)
    assert torch.equal(again["s1b0"]["proj"]["w"],
                       tres.init(7, tcfg, device=CPU)[0]["s1b0"]["proj"]["w"])


def test_conv_layer_names_match_reference():
    for depth, widths in ((20, (16, 32, 64)), (18, (16, 32, 64))):
        jcfg = jres.ResNetConfig(name="n", depth=depth, n_classes=10,
                                 widths=widths)
        tcfg = tres.ResNetConfig(name="n", depth=depth, n_classes=10,
                                 widths=widths)
        assert tres.conv_layer_names(tcfg) == jres.conv_layer_names(jcfg)
    assert len(tres.conv_layer_names(tres.ResNetConfig(
        name="r20", depth=20, n_classes=10))) == 20


def test_pack_model_refuses_what_is_not_ported():
    tc = TCIMConfig(**CIM)
    g = torch.Generator().manual_seed(0)
    # stacked layers and MoE expert banks pack one slice at a time (they
    # were refused before the transformer slice; tests/test_torch_
    # transformer.py holds them against the reference byte for byte)
    stacked = {"blk": {"w": torch.randn((2, 8, 4), generator=g),
                       "s_w": torch.ones(2, 1, 1),
                       "s_p": torch.ones(2, 3, 1, 1), "s_a": torch.ones(2, 1)}}
    got = tapi.pack_model(stacked, tc, device=CPU)["blk"]
    one = tapi.pack_model({k: v[1] for k, v in stacked["blk"].items()}, tc,
                          device=CPU)
    assert set(got) == set(one)
    for k, v in one.items():
        assert torch.equal(got[k][1], v), k
    bank = {"moe": {"wg": torch.randn((4, 8, 6), generator=g),
                    "wg_s_w": torch.ones(4, 1, 1),
                    "wg_s_p": torch.ones(4, 3, 1, 1),
                    "wg_s_a": torch.ones(4, 1)}}
    moe = tapi.pack_model(bank, tc, device=CPU)["moe"]
    assert "wg" not in moe and moe["wg_digits"].shape[0] == 4
    assert torch.equal(moe["wg_digits"][2], tapi.pack_model(
        {"w": bank["moe"]["wg"][2], "s_w": torch.ones(1, 1),
         "s_p": torch.ones(3, 1, 1), "s_a": torch.ones(1)}, tc,
        device=CPU)["w_digits"])
    # a weight of a rank no CIM layer has is refused
    with pytest.raises(ValueError, match="rank"):
        tapi.pack_model({"x": {"w": torch.zeros(1, 2, 3, 4, 5, 6),
                               "s_w": torch.ones(1), "s_p": torch.ones(1),
                               "s_a": torch.ones(1)}}, tc, device=CPU)
    # full-precision nodes pass through untouched
    fp = {"fc": {"w": torch.ones(3, 2), "b": torch.zeros(2)}}
    assert torch.equal(tapi.pack_model(fp, tc, device=CPU)["fc"]["w"],
                       fp["fc"]["w"])


def test_make_image_dataset_matches_reference():
    x, y = make_image_dataset(hw=16, n=12, seed=3)
    jx, jy = j_make_image_dataset(hw=16, n=12, seed=3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.dtype == jx.dtype and y.dtype == np.int32
