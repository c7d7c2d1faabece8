"""Shared parts of the LM training step's parity tests against the JAX
package (``tests/test_torch_lm_train_{dense,mla,moe,recurrent}.py``,
split so that each file's JAX compilations stay under a minute).

Each case: a registry entry at its ``reduced()`` size in float32 (the
JAX side without remat: remat recomputes, it changes no value), params
initialised by the JAX package and carried across as numpy
(``repro_torch.interop``), one batch of the JAX package's LM stream
(``repro.data.pipeline.make_lm_pipeline``: randomness does not cross
frameworks, so both packages read the same numpy tokens) and, where the
entry has a front end, numpy input at ``frontend_input_shape`` (raw
log-mel frames, images).

Held against the reference:
- the loss and every parameter gradient of the port's
  ``train.trainer.lm_loss_fn`` against ``jax.value_and_grad`` of
  ``repro.train.trainer.lm_loss_fn`` (jitted);
- one step of the port's ``make_train_step`` against the reference's
  step on the same gradients: ``repro.optim.schedule.cosine_warmup`` and
  ``repro.optim.optimizer``'s AdamW step (what
  ``repro.train.trainer.make_train_step``'s ``train_step`` runs), the
  updated params, the optimizer state and the metrics.

Tolerance: each leaf within ``REL`` = 1e-4 of its largest magnitude (the
zoo's logit gate, ``chip_smoke.py`` phase 13, per leaf); a leaf that is
zero in the reference must be zero in the port. The reference's own
jit-against-eager spread (``tests/test_torch_qat.py`` widens by twice it)
was measured at most 1.8e-7 on these leaves, the port's largest
difference 3.4e-6 of a leaf's largest magnitude (xlstm's embedding), so
the gate is not widened. The params after the step add, per element,
what the gradient's own difference dg can move AdamW's first update
g / (|g| + eps): at most 2 |dg| / (|g| + eps) of the learning rate, which
is large only where |g| is near eps (xlstm's sLSTM bias).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.data.pipeline import make_lm_pipeline as j_lm_pipeline
from repro.models.registry import frontend_input_shape
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim.optimizer import make_optimizer as j_make_optimizer
from repro.train.trainer import lm_loss_fn as j_lm_loss_fn
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.interop import from_numpy_tree
from repro_torch.models.registry import get_model
from repro_torch.train.trainer import (lm_loss_fn, loss_and_grads,
                                       make_train_step)

CPU = "cpu"
B, T = 2, 16
REL = 1e-4
#: the CIM config of tests/test_models.py::test_cim_enabled_lm_trains
LM_CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
              act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
RUN = dict(lr=1e-3, total_steps=10, warmup_steps=2)


def configs(arch, cim=None):
    """(JAX config, port config) of ``arch``'s reduced entry in float32,
    under ``cim`` (a dict of CIMConfig fields) when given."""
    jcfg = j_get_config(arch, reduced=True,
                        cim=None if cim is None else JCIMConfig(**cim))
    tcfg = get_config(arch, reduced=True,
                      cim=None if cim is None else CIMConfig(**cim))
    return (jcfg.replace(compute_dtype="float32", remat=False),
            tcfg.replace(compute_dtype="float32"))


def stream_batch(cfg, b=B, t=T, step=0):
    """Batch ``step`` of the JAX package's LM stream, (b, t+1) int32, with
    the front-end input at ``frontend_input_shape`` (numpy, seed 2, x 0.1)
    where the entry has one."""
    pipe = j_lm_pipeline(vocab=cfg.vocab, seq_len=t, global_batch=b)
    for _ in range(step):
        next(pipe)
    batch = {"tokens": next(pipe)["tokens"]}
    shape = frontend_input_shape(cfg, b)
    if shape is not None:
        batch["frontend"] = (np.random.default_rng(2).standard_normal(shape)
                             * 0.1).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def assert_tree_close(got, want, rel=REL, path=""):
    """Every leaf of ``got`` (tensors) within ``rel`` of the largest
    magnitude of ``want``'s leaf (numpy or jax); zero leaves exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], rel, f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, rel, f"{path}/{i}")
        return
    w = np.asarray(want, np.float32)
    g = got.detach().to(torch.float32).numpy()
    assert g.shape == w.shape, (path, g.shape, w.shape)
    scale = float(np.abs(w).max()) if w.size else 0.0
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= rel * scale, (path, err, scale)


def _assert_step_close(got, want, g_got, g_want, lr, eps=1e-8, path=""):
    """Params after one AdamW step: within REL of each leaf's largest
    magnitude plus, per element, lr * min(2, 2 |dg| / (|g| + eps)), the
    most the gradients' difference dg moves the first update."""
    if isinstance(want, dict):
        for k in want:
            _assert_step_close(got[k], want[k], g_got[k], g_want[k], lr, eps,
                               f"{path}/{k}")
        return
    w = np.asarray(want, np.float32)
    g = got.detach().to(torch.float32).numpy()
    gw = np.asarray(g_want, np.float32)
    dg = np.abs(g_got.detach().to(torch.float32).numpy() - gw)
    lim = (REL * float(np.abs(w).max(initial=0.0))
           + lr * np.minimum(2.0, 2.0 * dg / (np.abs(gw) + eps)))
    assert np.all(np.abs(g - w) <= lim), (path, float(np.abs(g - w).max()))


def reference_step(arch, cim=None, batch=None):
    """The JAX side of one case: params (numpy), the batch, the loss and
    gradients, and the params, optimizer state, gradient norm and learning
    rate after one AdamW step on them."""
    jcfg, _ = configs(arch, cim)
    model = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(model.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    batch = stream_batch(jcfg) if batch is None else batch
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(j_lm_loss_fn(model, jcfg)))(
        params, jb)
    run = JRunConfig(**RUN)
    opt = j_make_optimizer(run.optimizer)
    state = opt.init(params, jnp.float32)
    lr = j_cosine_warmup(state["step"], base_lr=run.lr,
                         warmup_steps=run.warmup_steps,
                         total_steps=run.total_steps)
    new_params, new_state, gnorm = jax.jit(
        lambda p, g, s, l: opt.step(p, g, s, l,
                                    weight_decay=run.weight_decay,
                                    grad_clip=run.grad_clip))(
        params, grads, state, lr)
    npy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return {"params": npy(params), "batch": batch, "loss": float(loss),
            "grads": npy(grads), "new_params": npy(new_params),
            "new_state": npy(new_state), "grad_norm": float(gnorm),
            "lr": float(lr)}


def check_against_reference(arch, ref, cim=None):
    """The port's loss, gradients and one train step against ``ref``
    (``reference_step``). Returns the port's gradients."""
    _, tcfg = configs(arch, cim)
    model = get_model(tcfg)
    params = from_numpy_tree(ref["params"], CPU)
    batch = port_batch(ref["batch"])
    loss, grads = loss_and_grads(lm_loss_fn(model, tcfg), params, batch)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    assert_tree_close(grads, ref["grads"])

    init_state, train_step = make_train_step(model, tcfg, RunConfig(**RUN))
    new_params, new_state, m = train_step(params, init_state(params), batch)
    _assert_step_close(new_params, ref["new_params"], grads, ref["grads"],
                       ref["lr"])
    assert_tree_close(new_state, ref["new_state"])
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), ref["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), ref["lr"], rtol=1e-6)
    assert int(m["step"]) == 1
    return grads
