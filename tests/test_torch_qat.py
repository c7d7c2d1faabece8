"""QAT on the port against the JAX package, on the CPU at a small size.

The emulate linear and conv layers' gradients with respect to the weight,
the three LSQ scales and the input are held against ``jax.grad`` at
float32 compute (layer, array and column granularity, the psum ADC on and
off, psum bits 1 and 4) at rtol 1e-4 / atol 1e-5, widened by twice the
reference's own spread on each leaf: the largest difference between its
jitted and its eager gradient. The scale gradients are sums that cancel
(with the ADC off, ds_a is two terms of about L / s_a each), and the two
evaluations of the reference differ by up to 2.1e-4 there, more than
the 1e-4 alone admits. The reduced ResNet-20's cross-entropy loss and
every parameter's gradient are held against the JAX QAT harness's
``_loss_fn`` (``benchmarks/common.py``) at rtol 1e-4 / atol 1e-5. Inputs
are made with numpy from a seed and params cross by ``interop``.

``train_qat`` follows the harness step by step: each of 5 steps of the
JAX harness's own run is replayed by the port from the same params,
momentum, BN state, batch and learning rate (loss at rtol 1e-5, the
updated params at rtol 1e-4), and the port's one-step ``train_qat``
equals the harness's first step at rtol 1e-4. The two runs are not
compared free-running: at this size a one-ulp change of one column
scale flips weight codes and moves the next loss by up to 12 %, on
either package. The optimizers, clipping and the cosine schedule follow
``tests/test_trainer.py`` against ``repro.optim``.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.data import pipeline as jpipe
from repro.models import resnet as jres
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim import optimizer as jopt
from repro_torch import api as tapi
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import resnet as tres
from repro_torch.optim import cosine_warmup
from repro_torch.optim import optimizer as topt
from repro_torch.train import qat

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from benchmarks import common as jqat  # noqa: E402  (the JAX QAT harness)

CPU = "cpu"
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# the reduced ResNet-20: widths 4/8/16 at 8x8, batch 8, 64-row arrays
WIDTHS, HW, BATCH = (4, 8, 16), 8, 8


def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                act_bits=3, psum_bits=4, array_rows=32, array_cols=32,
                act_signed=False)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _leaves_sorted(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_sorted(tree[k])
    else:
        yield tree


def _spread_close(got, jit, eager, path=""):
    """got == the reference's jitted value at GRAD_TOL, widened per leaf by
    twice its largest difference from the reference's eager value."""
    if isinstance(jit, dict):
        assert set(got) == set(jit), path
        for k in jit:
            _spread_close(got[k], jit[k], eager[k], f"{path}/{k}")
        return
    got = got.detach().numpy()
    jit, eager = np.asarray(jit), np.asarray(eager)
    spread = float(np.abs(jit - eager).max()) if jit.size else 0.0
    err = np.abs(got - jit)
    lim = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(jit) + 2 * spread
    assert np.all(err <= lim), (path, float(err.max()), spread)


def _tree_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=path, **tol)


def _requires_grad(tree):
    return {k: (_requires_grad(v) if isinstance(v, dict)
                else v.requires_grad_(True)) for k, v in tree.items()}


def _grads(tree):
    """The leaves' gradients; an unused leaf (``s_p`` with the ADC off)
    has none, where ``jax.grad`` gives zeros."""
    return {k: (_grads(v) if isinstance(v, dict) else
                torch.zeros_like(v) if v.grad is None else v.grad)
            for k, v in tree.items()}


GRAD_CASES = [(g, pq, pb) for g in ("layer", "array", "column")
              for pq, pb in ((True, 1), (True, 4), (False, 4))]


@pytest.mark.parametrize("gran,psum_quant,psum_bits", GRAD_CASES)
def test_linear_emulate_gradients_match_reference(gran, psum_quant,
                                                  psum_bits):
    jc, tc = _cfgs(weight_granularity=gran, psum_granularity=gran,
                   psum_quant=psum_quant, psum_bits=psum_bits)
    rng = np.random.RandomState(5)
    x = np.maximum(rng.randn(6, 70), 0).astype(np.float32)
    r = rng.randn(6, 20).astype(np.float32)
    p = tapi.init_linear(torch.Generator().manual_seed(3), 70, 20, tc,
                         device=CPU)
    p_np = to_numpy_tree(tapi.calibrate_linear(torch.from_numpy(x), p, tc))

    def ref(p_, x_):
        return jax.value_and_grad(lambda a, b: jnp.sum(japi.linear(
            b, a, jc, compute_dtype=jnp.float32) * r), argnums=(0, 1))(p_, x_)

    loss_j, grads_j = jax.jit(ref)(p_np, x)
    _, grads_e = ref(p_np, x)
    tp = _requires_grad(from_numpy_tree(p_np, CPU))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(tapi.linear(xt, tp, tc, compute_dtype=torch.float32)
                     * torch.from_numpy(r))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert set(tp) == {"w", "s_w", "s_p", "s_a"}
    _spread_close({"p": _grads(tp), "x": xt.grad},
                  dict(zip("px", grads_j)), dict(zip("px", grads_e)))


@pytest.mark.parametrize("gran,psum_quant,psum_bits", GRAD_CASES)
def test_conv_emulate_gradients_match_reference(gran, psum_quant, psum_bits):
    jc, tc = _cfgs(weight_granularity=gran, psum_granularity=gran,
                   psum_quant=psum_quant, psum_bits=psum_bits, array_cols=16)
    stride = 2 if gran == "array" else 1
    rng = np.random.RandomState(6)
    x = np.maximum(rng.randn(2, 7, 7, 8), 0).astype(np.float32)
    p = tapi.init_conv(torch.Generator().manual_seed(4), 3, 3, 8, 10, tc,
                       device=CPU)
    p_np = to_numpy_tree(tapi.calibrate_conv(torch.from_numpy(x), p, tc,
                                             stride=stride))
    ho = -(-7 // stride)
    r = rng.randn(2, ho, ho, 10).astype(np.float32)

    def ref(p_, x_):
        return jax.value_and_grad(lambda a, b: jnp.sum(japi.conv2d(
            b, a, jc, stride=stride, compute_dtype=jnp.float32) * r),
            argnums=(0, 1))(p_, x_)

    loss_j, grads_j = jax.jit(ref)(p_np, x)
    _, grads_e = ref(p_np, x)
    tp = _requires_grad(from_numpy_tree(p_np, CPU))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.sum(tapi.conv2d(xt, tp, tc, stride=stride,
                                 compute_dtype=torch.float32)
                     * torch.from_numpy(r))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    _spread_close({"p": _grads(tp), "x": xt.grad},
                  dict(zip("px", grads_j)), dict(zip("px", grads_e)))


@pytest.fixture(scope="module")
def reduced():
    """The reduced ResNet-20 and its data, initialised and calibrated by the
    JAX package (jitted), as numpy trees."""
    cim = jqat.make_cim("column", "column", array=64)
    jcfg = jres.ResNetConfig(name="resnet20-bench", depth=20, n_classes=10,
                             widths=WIDTHS, in_hw=HW, cim=cim)
    data = _small_data()
    (xtr, _), _ = data
    params, state = jax.jit(lambda k: jres.init(k, jcfg))(
        jax.random.PRNGKey(0))
    params = jax.jit(lambda p, s, x_: jres.calibrate(p, s, x_, jcfg))(
        params, state, jnp.asarray(xtr[:qat.CALIBRATION_IMAGES]))
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"jcfg": jcfg, "data": data, "params": np_tree(params),
            "state": np_tree(state)}


def _small_data():
    x, y = tpipe.make_image_dataset(n_classes=10, hw=HW, n=64, seed=0)
    return (x[16:], y[16:]), (x[:16], y[:16])


def _tcfg():
    return qat.resnet_cfg(qat.make_cim("column", "column", array=64),
                          widths=WIDTHS, hw=HW)


def test_reduced_resnet20_loss_and_gradients_match_reference(reduced):
    (xtr, ytr), _ = reduced["data"]
    xb, yb = tpipe.synth_classification_batch(xtr, ytr, BATCH, 0, 0)
    jcfg = reduced["jcfg"]

    @jax.jit
    def ref(p, s, x_, y_):
        return jax.value_and_grad(jqat._loss_fn, has_aux=True)(p, s, x_, y_,
                                                                 jcfg)

    (loss_j, state_j), g_j = ref(reduced["params"], reduced["state"],
                                 jnp.asarray(xb), jnp.asarray(yb))
    tp = _requires_grad(from_numpy_tree(reduced["params"], CPU))
    ts = from_numpy_tree(reduced["state"], CPU)
    loss, state = qat._loss_fn(tp, ts, xb, yb, _tcfg(), CPU)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), **GRAD_TOL)
    _tree_close(_grads(tp), g_j, **GRAD_TOL)
    _tree_close(state, state_j, **GRAD_TOL)


class _StepRecorder:
    """Stands in for ``jax`` inside the JAX harness: ``jit`` records each
    call of the jitted QAT step, its inputs and outputs as numpy."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        jitted = jax.jit(fn)

        def step(*args):
            out = jitted(*args)
            self.calls.append(jax.tree.map(np.asarray, (args, out)))
            return out
        return step


def test_train_qat_steps_match_reference(reduced, monkeypatch):
    monkeypatch.setattr(jqat, "WIDTHS", WIDTHS)
    monkeypatch.setattr(jqat, "HW", HW)
    rec = _StepRecorder()
    monkeypatch.setattr(jqat, "jax", rec)
    kw = dict(batch=BATCH, lr=0.05, seed=0, data=reduced["data"])
    jqat.train_qat(jqat.make_cim("column", "column", array=64), steps=5,
                   params=reduced["params"], state=reduced["state"], **kw)
    assert len(rec.calls) == 5
    cfg = _tcfg()
    for it, ((p, st, mom, xb, yb, lr_t), (p1, st1, mom1, loss)) in \
            enumerate(rec.calls):
        got = qat.qat_step(from_numpy_tree(p, CPU), from_numpy_tree(st, CPU),
                           from_numpy_tree(mom, CPU), xb, yb, float(lr_t),
                           cfg, CPU)
        np.testing.assert_allclose(got[3].item(), float(loss), rtol=1e-5,
                                   err_msg=f"step {it}")
        _tree_close(got[0], p1, f"step {it} params", rtol=1e-4, atol=1e-6)
        _tree_close(got[1], st1, f"step {it} state", rtol=1e-4, atol=1e-6)
        _tree_close(got[2], mom1, f"step {it} momentum", **GRAD_TOL)
    # the port's own loop, one step: the harness's first step
    one = qat.train_qat(qat.make_cim("column", "column", array=64), steps=1,
                        params=from_numpy_tree(reduced["params"], CPU),
                        state=from_numpy_tree(reduced["state"], CPU),
                        widths=WIDTHS, hw=HW, device=CPU, **kw)
    _tree_close(one["params"], rec.calls[0][1][0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(one["losses"], [float(rec.calls[0][1][3])],
                               rtol=1e-5)


def test_train_qat_lowers_the_loss():
    """30 steps at batch 32 from the seed: the mean loss of the last 5
    steps is below that of the first 5."""
    x, y = tpipe.make_image_dataset(n_classes=10, hw=HW, n=512, seed=0)
    out = qat.train_qat(qat.make_cim("column", "column"), steps=30,
                        batch=32, widths=WIDTHS, hw=HW, device=CPU,
                        data=((x[128:], y[128:]), (x[:128], y[:128])))
    losses = np.asarray(out["losses"])
    assert np.all(np.isfinite(losses))
    assert losses[-5:].mean() < losses[:5].mean(), losses


def test_train_qat_from_scratch_calibrates_and_trains():
    """Without params the harness initialises from the seed and calibrates
    the scales on the first 128 training images before training."""
    out = qat.train_qat(qat.make_cim("column", "column", array=64), steps=2,
                        batch=BATCH, widths=WIDTHS, hw=HW, device=CPU,
                        data=_small_data())
    init, _ = tres.init(0, out["cfg"], device=CPU)
    assert not torch.equal(out["params"]["s0b0"]["conv1"]["s_a"],
                           init["s0b0"]["conv1"]["s_a"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert set(out["mom"]) == set(out["params"])


def test_synth_classification_batch_matches_reference():
    x, y = tpipe.make_image_dataset(n_classes=10, hw=8, n=50, seed=3)
    for step in (0, 1, 17):
        xb, yb = tpipe.synth_classification_batch(x, y, 9, step, seed=2)
        xj, yj = jpipe.synth_classification_batch(x, y, 9, step, seed=2)
        np.testing.assert_array_equal(xb, xj)
        np.testing.assert_array_equal(yb, yj)


# ---------------------------------------------------------------------------
# optimizers, clipping and the schedule (as tests/test_trainer.py)
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.randn(4, 6).astype(np.float32),
            "b": {"c": rng.randn(5).astype(np.float32)}}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizer_steps_match_reference(name, state_dtype):
    rng = np.random.RandomState(9)
    params = _opt_tree(rng)
    jo, to = jopt.make_optimizer(name), topt.make_optimizer(name)
    jp, js = params, jo.init(params, getattr(jnp, state_dtype))
    tp = from_numpy_tree(params, CPU)
    ts = to.init(tp, getattr(torch, state_dtype))
    for i in range(3):
        grads = _opt_tree(rng)
        jp, js, jn = jo.step(jp, grads, js, 0.05)
        tp, ts, tn = to.step(tp, from_numpy_tree(grads, CPU), ts, 0.05)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _tree_close(tp, jp, rtol=1e-5, atol=1e-7)
    for a, b in zip(_leaves_sorted(ts), jax.tree.leaves(js), strict=True):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_allclose(a.to(torch.float32).numpy(),
                                   np.asarray(b, np.float32), rtol=1e-2,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgdm"])
def test_optimizers_reduce_quadratic(name):
    opt = topt.make_optimizer(name)
    params = {"w": torch.tensor([2.0, -3.0, 1.5])}
    state = opt.init(params)
    lr = {"adamw": 0.1, "adafactor": 0.3, "sgdm": 0.1}[name]
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.step(params, grads, state, lr,
                                    weight_decay=0.0, grad_clip=0.0)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_state_dtype_bf16():
    opt = topt.make_optimizer("adamw")
    params = {"w": torch.ones(4)}
    state = opt.init(params, torch.bfloat16)
    assert state["m"]["w"].dtype == torch.bfloat16
    params2, state, _ = opt.step(params, {"w": torch.ones(4)}, state, 1e-2)
    assert params2["w"].dtype == torch.float32
    assert state["v"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("max_norm", [0.0, 1.0, 1e9])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _opt_tree(np.random.RandomState(2))
    tree["w"] *= 100
    jg, jn = jopt.clip_by_global_norm(tree, max_norm)
    tg, tn = topt.clip_by_global_norm(from_numpy_tree(tree, CPU), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _tree_close(tg, jg, rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-6)


def test_grad_clipping_bounds_update():
    opt = topt.make_optimizer("sgdm")
    params = {"w": torch.zeros(3)}
    huge = {"w": torch.tensor([1e6, -1e6, 1e6])}
    p2, _, gnorm = opt.step(params, huge, opt.init(params), lr=1.0,
                            momentum=0.0, weight_decay=0.0, grad_clip=1.0)
    assert float(gnorm) > 1e5
    assert float(torch.linalg.norm(p2["w"])) <= 1.0 + 1e-5


def test_cosine_warmup_matches_reference():
    kw = dict(base_lr=0.3, warmup_steps=10, total_steps=100)
    for step in (0, 5, 10, 11, 55, 100, 140):
        np.testing.assert_allclose(
            float(cosine_warmup(torch.tensor(step), **kw)),
            float(j_cosine_warmup(jnp.asarray(step), **kw)), rtol=1e-6)
    assert float(cosine_warmup(100, **kw)) == pytest.approx(0.03, abs=1e-4)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion")
