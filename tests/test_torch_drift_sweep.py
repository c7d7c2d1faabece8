"""The port's Monte-Carlo drift sweep against the JAX package's, on the
CPU: ``monte_carlo_resnet(drift_schedule=...)`` on a small ResNet-20,
with the reference's per-sample, per-layer drift fields handed in by
``_torch_drift_source.JaxDriftSource``. Accuracies equal the
reference's, the logit error is within 1e-5, the persistent fields are
shared across t (the error grows with t), and a zero schedule skips
every evaluation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from _torch_drift_source import JaxDriftSource
from repro import api as japi
from repro.core import variation as jvar
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.eval import robustness as jrob
from repro.models import resnet as jres
from repro_torch import api as tapi
from repro_torch.core import variation as tvar
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.data.pipeline import make_image_dataset
from repro_torch.eval import robustness as rob
from repro_torch.interop import from_numpy_tree
from repro_torch.models import resnet as tres

CPU = "cpu"
# paper's CIFAR-10 settings on 64-row arrays, as test_torch_robustness.py
CIM_RES = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
               act_bits=3, psum_bits=4, array_rows=64, array_cols=64,
               act_signed=False)


def test_monte_carlo_drift_sweep_matches_reference():
    common = dict(name="tiny", depth=20, n_classes=10, widths=(8, 16),
                  in_hw=8)
    jcfg = jres.ResNetConfig(cim=JCIMConfig(**CIM_RES), **common)
    tcfg = tres.ResNetConfig(cim=TCIMConfig(**CIM_RES), **common)
    raw, state = jax.jit(lambda k: jres.init(k, jcfg))(jax.random.PRNGKey(0))
    x, y = make_image_dataset(hw=8, n=6, seed=1)
    params = jax.jit(lambda p, s, x_: jres.calibrate(p, s, x_, jcfg))(
        raw, state, jnp.asarray(x))
    # the reference's deploy arithmetic through its plain oracles
    jd = dataclasses.replace(jcfg, cim=jcfg.cim.replace(mode="ref",
                                                        use_kernel=False))
    key = jax.random.PRNGKey(5)
    sched = dict(cell_rate=1e-3, col_rate=1e-3)
    ts_grid = (0, 64, 256, 512)
    want = jrob.monte_carlo_resnet(
        jax.jit(lambda p: japi.pack_model(p, jcfg.cim))(params), state, jd,
        x, y, key=key,
        n_samples=2, batch=4, drift_schedule=jvar.DriftSchedule(**sched),
        drift_ts=ts_grid)

    tp = from_numpy_tree(jax.tree.map(np.asarray, params), CPU)
    tstate = from_numpy_tree(jax.tree.map(np.asarray, state), CPU)
    packed = tapi.pack_model(tp, tcfg.cim, device=CPU)
    td = dataclasses.replace(tcfg, cim=tcfg.cim.replace(mode="deploy"))
    src = JaxDriftSource(key, lambda k: jres.variation_keys(k, jcfg))
    got = rob.monte_carlo_resnet(
        packed, tstate, td, x, y, seed=src, n_samples=2, batch=4,
        drift_schedule=tvar.DriftSchedule(**sched), drift_ts=ts_grid,
        device=CPU)
    assert got.sigmas == want.sigmas == tuple(float(t) for t in ts_grid)
    np.testing.assert_array_equal(got.acc, want.acc)
    assert got.acc_clean == want.acc_clean
    np.testing.assert_allclose(got.logit_err, want.logit_err, rtol=0,
                               atol=1e-5)
    # the persistent fields are shared across t: the error grows with t
    assert np.all(np.diff(got.logit_err[1:], axis=0) > 0)
    # a zero schedule skips every evaluation
    zero = rob.monte_carlo_resnet(
        packed, tstate, td, x, y, seed=0, n_samples=1, batch=4,
        drift_schedule=tvar.DriftSchedule(), drift_ts=(0, 512), device=CPU)
    assert np.all(zero.acc == zero.acc_clean) and np.all(zero.logit_err == 0)
