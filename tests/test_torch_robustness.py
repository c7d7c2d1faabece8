"""The port's Monte-Carlo robustness harness, and one ResNet-20 cell-noise
realization against the JAX package's, on the CPU.

The realization: the JAX package initialises and calibrates a small
ResNet-20; its per-layer noise fields are drawn by JAX exactly as its
forward draws them (``resnet.variation_keys``, then ``jax.random.normal``
over each layer's logical packed shape) and handed to the port as a
{layer name: theta} dict. Logits match ``repro.models.resnet.forward(
variation_key=...)`` at 1e-4 on deploy and on adc_free, and within the
port deploy equals emulate under the same fields bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.models import resnet as jres
from repro_torch import api as tapi
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.data.pipeline import make_image_dataset
from repro_torch.eval import robustness as rob
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import resnet as tres

CPU = "cpu"
SIGMA = 0.3
# paper's CIFAR-10 settings on 64-row arrays, as tests/test_torch_resnet.py
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
    """JAX init + calibrate of a small ResNet-20 (jitted), as numpy."""
    jcfg, _ = _cfgs()
    raw, state = jax.jit(lambda k: jres.init(k, jcfg))(jax.random.PRNGKey(0))
    x, y = make_image_dataset(hw=8, n=6, seed=1)
    params = jax.jit(lambda p, s, x_: jres.calibrate(p, s, x_, jcfg))(
        raw, state, jnp.asarray(x))
    return _np(params), _np(state), x, y


def _logical_shape(node):
    d = node["w_digits"]
    shape = list(d.shape)
    if d.dtype == torch.uint8:
        shape[-2] *= 2
    return tuple(shape)


@pytest.mark.parametrize("mode,pack_dtype", [("deploy", "int4"),
                                             ("adc_free", "int8")])
def test_resnet_realization_matches_reference(reference, mode, pack_dtype):
    params, state, x, _ = reference
    jcfg, tcfg = _cfgs(pack_dtype=pack_dtype)
    tp, ts = from_numpy_tree(params, CPU), from_numpy_tree(state, CPU)
    packed = tapi.pack_model(tp, tcfg.cim, device=CPU)
    names = [n for n, _ in tres.conv_layer_names(tcfg)]
    shapes = {n: _logical_shape(packed[n.split(".")[0]][n.split(".")[1]])
              for n in names}
    key = jax.random.PRNGKey(7)
    # the reference's deploy arithmetic through its plain oracles
    j_mode = "ref" if mode == "deploy" else mode
    jd = dataclasses.replace(jcfg, cim=jcfg.cim.replace(mode=j_mode,
                                                        use_kernel=False))

    @jax.jit
    def jax_side(p, s, x_):
        vkeys = jres.variation_keys(key, jcfg)
        thetas = {n: jax.random.normal(vkeys[n], shapes[n], jnp.float32)
                  for n in names}
        pk = japi.pack_model(p, jcfg.cim)
        return thetas, jres.forward(pk, s, x_, jd, train=False,
                                    variation_key=key,
                                    variation_std=SIGMA)[0]

    thetas, want = _np(jax_side(params, state, x))
    td = dataclasses.replace(tcfg, cim=tcfg.cim.replace(mode=mode))
    got, _ = tres.forward(packed, ts, x, td, train=False, variation=thetas,
                          variation_std=SIGMA, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    clean, _ = tres.forward(packed, ts, x, td, train=False, device=CPU)
    assert not torch.equal(clean, got)
    if mode == "deploy":
        # within the port, deploy equals emulate under the same fields
        y_e, _ = tres.forward(tp, ts, x, tcfg, train=False, variation=thetas,
                              variation_std=SIGMA, device=CPU)
        assert torch.equal(got, y_e)


@pytest.mark.parametrize("mode", ["deploy", "adc_free", "binary"])
def test_monte_carlo_linear_error_covers_backends(mode):
    tc = TCIMConfig(**dict(CIM, array_rows=32, array_cols=32))
    x = torch.relu(torch.randn((6, 40), generator=torch.Generator()
                               .manual_seed(1)))
    p = tapi.init_linear(torch.Generator().manual_seed(0), 40, 24, tc,
                         device=CPU)
    p = tapi.calibrate_linear(x, p, tc)
    cfg = tc.replace(mode=mode)
    packed = tapi.pack_linear(p, cfg)
    sigmas = (0.0, 0.05, 0.2)
    errs = rob.monte_carlo_linear_error(packed, cfg, x, seed=3,
                                        sigmas=sigmas, n_samples=3,
                                        device=CPU)
    assert errs.shape == (len(sigmas), 3)
    assert np.all(np.isfinite(errs)) and np.all(errs >= 0)
    assert np.all(errs[0] == 0)
    # more cell noise, more error (monotone in the mean)
    assert errs[2].mean() > errs[1].mean() > 0
    # the same seed gives the same sweep
    again = rob.monte_carlo_linear_error(packed, cfg, x, seed=3,
                                         sigmas=sigmas, n_samples=3,
                                         device=CPU)
    np.testing.assert_array_equal(errs, again)


def test_resnet_sweep_and_attribution(reference):
    params, state, x, y = reference
    _, tcfg = _cfgs()
    tp, ts = from_numpy_tree(params, CPU), from_numpy_tree(state, CPU)
    packed = tapi.pack_model(tp, tcfg.cim, device=CPU)
    td = dataclasses.replace(tcfg, cim=tcfg.cim.replace(mode="deploy"))
    sweep = rob.monte_carlo_resnet(packed, ts, td, x, y, seed=0,
                                   sigmas=(0.0, 0.1, 0.4), n_samples=2,
                                   batch=4, device=CPU)
    assert sweep.acc.shape == sweep.logit_err.shape == (3, 2)
    assert np.all(sweep.acc[0] == sweep.acc_clean)
    assert np.all(sweep.logit_err[0] == 0)
    assert sweep.logit_err_mean[2] > sweep.logit_err_mean[1] > 0
    assert np.all((sweep.acc >= 0) & (sweep.acc <= 1))

    attr = rob.per_layer_attribution(packed, ts, td, x, seed=0, sigma=SIGMA,
                                     sample=1, device=CPU)
    assert [a.name for a in attr] == [n for n, _ in
                                      tres.conv_layer_names(tcfg)]
    for a in attr:
        blk, layer = a.name.split(".")
        c_out = packed[blk][layer]["w_digits"].shape[-1]
        assert a.col_err.shape == (c_out,)
        assert np.isfinite(a.rel_err) and a.rel_err > 0
        assert a.worst_col_err == a.col_err.max() >= a.median_col_err
    # attribution sees the noise of the end-to-end forward: one layer's
    # realization re-run alone gives the same layer output
    first = attr[0].name
    sampler = tapi.Sampler(0, sample=1)
    _, _, taps = tres.forward(packed, ts, x, td, train=False,
                              return_taps=True, device=CPU)
    blk, layer = first.split(".")
    y1 = tapi.conv2d(taps[first], packed[blk][layer], td.cim,
                     variation=sampler.for_layer(first), variation_std=SIGMA,
                     compute_dtype=torch.float32)
    y0 = tapi.conv2d(taps[first], packed[blk][layer], td.cim,
                     compute_dtype=torch.float32)
    rel = float(torch.linalg.norm((y1 - y0).double())
                / torch.linalg.norm(y0.double()))
    assert rel == pytest.approx(attr[0].rel_err, rel=1e-12)
    assert to_numpy_tree(packed)  # the tree still round-trips as numpy
