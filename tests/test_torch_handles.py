"""The port's layer handles, deprecated wrappers and dequant accounting
against the JAX package, on the CPU.

``QuantLinear`` / ``QuantConv2d`` go through the lifecycle on both
packages from the same params (``interop``): calibrate (scales at rtol
1e-5; the steps after it start from the reference's calibrated params),
the emulate forward with and without one cell-variation
realization (theta drawn by JAX over the logical packed layout, as in
``tests/test_torch_variation.py``), ``pack`` (planes byte for byte, the
same kind, config and meta), ``from_artifact`` and ``with_backend``
(outputs at rtol 1e-5 / atol 1e-4; within the port deploy == emulate
bit for bit). Every deprecated wrapper warns as the reference's does and
returns what its replacement returns. ``conv_dequant_muls`` (the x-axis
of the paper's Fig. 8) equals the reference's on every ResNet-20 conv for
every granularity pair.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import cim_conv as jconv
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro_torch import api as tapi
from repro_torch.core import cim_conv as tconv
from repro_torch.core import cim_linear as tlin
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.models import resnet as tres

CPU = "cpu"
OUT_TOL = dict(rtol=1e-5, atol=1e-4)
SIGMA = 0.2
CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
           act_bits=6, psum_bits=4, array_rows=32, array_cols=32,
           pack_dtype="int4")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_packed_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        if w.dtype.name == "int4":
            w = w.astype(np.int8)          # the port's dense int4 storage
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _handles(kind):
    jc, tc = JCIMConfig(**CIM), TCIMConfig(**CIM)
    if kind == "linear":
        x = np.maximum(np.random.RandomState(1).randn(5, 70), 0)
        jh = japi.QuantLinear(70, 20, jc).init(jax.random.PRNGKey(0))
        th = tapi.QuantLinear(70, 20, tc, params=from_numpy_tree(
            _np(jh.params), CPU))
    else:
        x = np.maximum(np.random.RandomState(2).randn(2, 9, 9, 12), 0)
        jh = japi.QuantConv2d(3, 3, 12, 20, jc, stride=2).init(
            jax.random.PRNGKey(0))
        th = tapi.QuantConv2d(3, 3, 12, 20, tc, stride=2,
                              params=from_numpy_tree(_np(jh.params), CPU))
    return jh, th, x.astype(np.float32)


def _logical_shape(packed):
    d = packed["w_digits"]
    shape = list(d.shape)
    if d.dtype == jnp.uint8:                 # nibble planes: rows halved
        shape[-2] *= 2
    return tuple(shape)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_handle_lifecycle_matches_reference(kind):
    jh, th, x = _handles(kind)
    jh.calibrate(jnp.asarray(x))
    th.calibrate(torch.from_numpy(x))
    for k in ("s_a", "s_p", "s_w", "w"):
        np.testing.assert_allclose(th.params[k].numpy(),
                                   np.asarray(jh.params[k]), rtol=1e-5)
    # the rest from the same calibrated params (the means above differ in
    # their last bit), so that the packs can be held byte for byte
    th.params = from_numpy_tree(_np(jh.params), CPU)
    xt = torch.from_numpy(x)
    y_t = th(xt)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(jh(jnp.asarray(x))),
                               **OUT_TOL)

    jart, tart = jh.pack(meta={"run": 3}), th.pack(meta={"run": 3})
    assert (tart.kind, tart.meta) == (jart.kind, jart.meta)
    assert dataclasses.asdict(tart.config) == dataclasses.asdict(jart.config)
    _assert_packed_equal(tart.params, jart.params)

    served = type(th).from_artifact(tart)
    y_d = served(xt)
    np.testing.assert_allclose(
        y_d.numpy(), np.asarray(type(jh).from_artifact(jart)(jnp.asarray(x))),
        **OUT_TOL)
    np.testing.assert_array_equal(y_d.numpy(), y_t.numpy())
    np.testing.assert_array_equal(served.with_backend("ref")(xt).numpy(),
                                  y_d.numpy())
    for h in (th, jh):
        with pytest.raises(ValueError, match="consumes packed digit planes"):
            h.with_backend("deploy")
    with pytest.raises(ValueError, match="expected a"):
        tapi.QuantConv2d.from_artifact(tart) if kind == "linear" else \
            tapi.QuantLinear.from_artifact(tart)

    # one cell-variation realization: theta from JAX's key, in the port
    key = jax.random.PRNGKey(7)
    theta = np.asarray(jax.random.normal(key, _logical_shape(jart.params),
                                         jnp.float32))
    y_jv = np.asarray(jh(jnp.asarray(x), variation=japi.Variation(key,
                                                                  SIGMA)))
    y_tv = th(xt, variation=tapi.Variation(theta, SIGMA))
    np.testing.assert_allclose(y_tv.numpy(), y_jv, **OUT_TOL)
    np.testing.assert_array_equal(
        served(xt, variation=tapi.Variation(theta, SIGMA)).numpy(),
        y_tv.numpy())


def test_handles_init_from_a_seed_and_guard_their_state():
    tc = TCIMConfig(**CIM)
    jh = japi.QuantLinear(70, 20, JCIMConfig(**CIM)).init(
        jax.random.PRNGKey(0))
    th = tapi.QuantLinear(70, 20, tc).init(5, device=CPU)
    assert {k: tuple(v.shape) for k, v in th.params.items()} == {
        k: tuple(v.shape) for k, v in jh.params.items()}
    again = tapi.QuantLinear(70, 20, tc).init(
        torch.Generator().manual_seed(5), device=CPU)
    assert torch.equal(again.params["w"], th.params["w"])
    conv = tapi.QuantConv2d(3, 3, 12, 20, tc).init(1, device=CPU)
    assert tuple(conv.params["w"].shape) == (3, 3, 12, 20)
    with pytest.raises(ValueError, match="no params"):
        tapi.QuantLinear(4, 4, tc)(torch.zeros(1, 4))
    packed = tapi.QuantLinear.from_artifact(th.pack())
    with pytest.raises(ValueError, match="trainable float weights"):
        packed.calibrate(torch.zeros(1, 70))
    with pytest.raises(ValueError, match="trainable float weights"):
        packed.pack()


def _resnet_params():
    cfg = tres.ResNetConfig(name="r20", depth=20, n_classes=10,
                            cim=TCIMConfig(**dict(CIM, weight_bits=3,
                                                  cell_bits=1)))
    return tres.init(0, cfg, device=CPU), cfg


LIN_ARGS = lambda: (torch.Generator().manual_seed(0), 70, 20,  # noqa: E731
                    TCIMConfig(**CIM))
CONV_ARGS = lambda: (torch.Generator().manual_seed(0), 3, 3, 12,  # noqa: E731
                     20, TCIMConfig(**CIM))


def _lin_params():
    x = torch.rand(5, 70, generator=torch.Generator().manual_seed(2))
    p = tlin._init_linear(*LIN_ARGS(), device=CPU)
    return tlin._calibrate_linear(x, p, TCIMConfig(**CIM)), x


def _conv_params():
    x = torch.rand(2, 9, 9, 12, generator=torch.Generator().manual_seed(2))
    p = tconv._init_conv(*CONV_ARGS(), device=CPU)
    return tconv._calibrate_conv(x, p, TCIMConfig(**CIM)), x


def _deprecated_calls():
    cfg = TCIMConfig(**CIM)
    lin, xl = _lin_params()
    conv, xc = _conv_params()
    (rp, _), rcfg = _resnet_params()
    return {
        "init_cim_linear": (lambda: tlin.init_cim_linear(*LIN_ARGS(),
                                                         device=CPU),
                            lambda: tlin._init_linear(*LIN_ARGS(),
                                                      device=CPU)),
        "cim_linear": (lambda: tlin.cim_linear(xl, lin, cfg),
                       lambda: tapi.linear(xl, lin, cfg)),
        "calibrate_cim": (lambda: tlin.calibrate_cim(xl, lin, cfg),
                          lambda: tapi.calibrate_linear(xl, lin, cfg)),
        "pack_deploy": (lambda: tlin.pack_deploy(lin, cfg),
                        lambda: tapi.pack_linear(lin, cfg)),
        "init_cim_conv": (lambda: tconv.init_cim_conv(*CONV_ARGS(),
                                                      device=CPU),
                          lambda: tconv._init_conv(*CONV_ARGS(),
                                                   device=CPU)),
        "cim_conv2d": (lambda: tconv.cim_conv2d(xc, conv, cfg, stride=2),
                       lambda: tapi.conv2d(xc, conv, cfg, stride=2)),
        "calibrate_cim_conv": (lambda: tconv.calibrate_cim_conv(xc, conv,
                                                                cfg),
                               lambda: tapi.calibrate_conv(xc, conv, cfg)),
        "pack_deploy_conv": (lambda: tconv.pack_deploy_conv(conv, cfg),
                             lambda: tapi.pack_conv(conv, cfg)),
        "models.resnet.pack_deploy": (
            lambda: tres.pack_deploy(rp, rcfg, device=CPU),
            lambda: tapi.pack_model(rp, rcfg.cim, device=CPU)),
    }


def _equal_trees(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(_deprecated_calls()))
def test_deprecated_wrapper_warns_and_forwards(name):
    old, new = _deprecated_calls()[name]
    with pytest.warns(DeprecationWarning,
                      match=rf"^{name} is deprecated; use repro_torch\.api\."):
        got = old()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        want = new()
    _equal_trees(got, want)


GRANS = ("layer", "array", "column")


@pytest.mark.parametrize("wg", GRANS)
@pytest.mark.parametrize("pg", GRANS)
def test_conv_dequant_muls_matches_reference(wg, pg):
    (params, _), cfg = _resnet_params()
    kw = dict(CIM, weight_bits=3, cell_bits=1, array_rows=128,
              array_cols=128, weight_granularity=wg, psum_granularity=pg)
    jc, tc = JCIMConfig(**kw), TCIMConfig(**kw)
    counts = []
    for name, _ in tres.conv_layer_names(cfg):
        blk, layer = name.split(".")
        p = params[blk][layer]
        want = jconv.conv_dequant_muls(
            {"w": np.zeros(tuple(p["w"].shape), np.float32)}, jc)
        got = tconv.conv_dequant_muls(p, tc)
        assert got == want, name
        counts.append(got)
    assert len(counts) == 20 and min(counts) >= 1
