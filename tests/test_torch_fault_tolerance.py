"""The port's fault-tolerant loop and straggler monitor
(``repro_torch.runtime``) against the JAX package's, on the CPU.

- A run crashed at step 7 and resumed from its newest checkpoint (step 5)
  ends with the params of the uninterrupted run, at the reference's
  tolerance (``tests/test_fault_tolerance.py``: rtol 1e-5, atol 1e-6),
  the stream started at the resumed step.
- The straggler policy gives the reference monitor's verdicts, counts,
  median and critical callbacks on the same sequence of step times.
- A ``TrainLoopState`` checkpoint written by either package's loop (params,
  AdamW state, step and an ``extra`` tree) resumes in the other's
  ``FaultTolerantLoop`` with equal leaves: the same tree names
  (``params``, ``opt_state``, ``step``, ``extra``) in the same format.
- The emergency save on a signal writes the current state and exits with
  128 + the signal; ``shardings`` is refused naming ROADMAP item 12.
"""
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import get_config as j_get_config
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.runtime.fault_tolerance import FaultTolerantLoop as JLoop
from repro.runtime.fault_tolerance import TrainLoopState as JState
from repro.runtime.straggler import StragglerMonitor as JMonitor
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch import tree_leaves, tree_map
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_lm_pipeline
from repro_torch.interop import from_numpy_tree
from repro_torch.models.registry import get_model
from repro_torch.nn.module import init_params
from repro_torch.runtime import (FaultTolerantLoop, StragglerMonitor,
                                 TrainLoopState)
from repro_torch.runtime.fault_tolerance import InjectedFailure
from repro_torch.train.trainer import make_train_step

CPU = "cpu"
ARCH = "qwen3-0.6b"


def _setup(path, ckpt_every=5):
    cfg = get_config(ARCH, reduced=True).replace(compute_dtype="float32")
    model = get_model(cfg)
    run = RunConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    init_state, train_step = make_train_step(model, cfg, run)

    def fresh():
        params = init_params(model.specs(cfg), 0, device=CPU)
        return TrainLoopState(params=params, opt_state=init_state(params),
                              step=0)

    def batches(start=0):
        for raw in make_lm_pipeline(vocab=cfg.vocab, seq_len=16,
                                    global_batch=4, start_step=start):
            yield {"tokens": torch.from_numpy(raw["tokens"])}

    loop = FaultTolerantLoop(str(path), checkpoint_every=ckpt_every,
                             async_save=False)
    return loop, fresh, train_step, batches


def test_crash_and_resume_matches_uninterrupted(tmp_path):
    loop, fresh, step, batches = _setup(tmp_path / "a")
    ref = loop.run(fresh(), step, batches(), total_steps=12)

    loop2, fresh2, step2, batches2 = _setup(tmp_path / "b")
    with pytest.raises(InjectedFailure):
        loop2.run(fresh2(), step2, batches2(), total_steps=12,
                  crash_at_step=7)
    st = loop2.resume_or_init(fresh2)
    assert st.step == 5
    st = loop2.run(st, step2, batches2(st.step), total_steps=12)
    assert st.step == ref.step == 12
    for a, b in zip(tree_leaves(ref.params), tree_leaves(st.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # the newest checkpoints are kept, the last one written once
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == [
        "step_00000005", "step_00000010", "step_00000012"]


def test_straggler_policy_matches_reference():
    rng = np.random.default_rng(0)
    times = np.abs(1.0 + 0.1 * rng.standard_normal(200))
    times[rng.integers(0, 200, 25)] *= rng.uniform(1.2, 5.0, 25)
    mons = [cls(window=32, warn_factor=1.5, crit_factor=3.0, min_samples=4)
            for cls in (StragglerMonitor, JMonitor)]
    crits = [[], []]
    for mon, out in zip(mons, crits):
        mon.on_critical = lambda t, med, out=out: out.append((t, med))
    for t in times:
        got, want = (m.observe(float(t)) for m in mons)
        assert got == want
        assert mons[0].median() == mons[1].median()
    assert (mons[0].n_warn, mons[0].n_crit) == (mons[1].n_warn,
                                                mons[1].n_crit)
    assert crits[0] == crits[1] and mons[0].n_crit > 0 < mons[0].n_warn
    mons[0].step_start()
    assert mons[0].step_end() in ("ok", "warn", "critical")


def _jax_state():
    """A reference TrainLoopState: reduced qwen3 params, AdamW state after
    one step, step 3 and an error-feedback tree in ``extra``."""
    cfg = j_get_config(ARCH, reduced=True).replace(compute_dtype="float32",
                                                   remat=False)
    model = j_get_model(cfg)
    params = jax.jit(lambda k: j_init_params(model.specs(cfg), k))(
        jax.random.PRNGKey(0))
    init_state, train_step = j_make_train_step(
        model, cfg, JRunConfig(lr=1e-3, total_steps=10, warmup_steps=2))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 9), 0, 64)
    params, opt, _ = jax.jit(train_step)(params, init_state(params),
                                         {"tokens": tokens})
    extra = {"ef": jax.tree.map(lambda p: p * 0.5, params["ln_f"])}
    return JState(params=params, opt_state=opt, step=3, extra=extra)


def _port_like(jst):
    """The port's fresh state of the same structure (zeros)."""
    tree = from_numpy_tree(jax.tree.map(np.asarray, {
        "params": jst.params, "opt_state": jst.opt_state,
        "extra": jst.extra}), CPU)
    return lambda: TrainLoopState(
        params=tree_map(torch.zeros_like, tree["params"]),
        opt_state=tree_map(torch.zeros_like, tree["opt_state"]),
        step=0, extra=tree_map(torch.zeros_like, tree["extra"]))


def _assert_leaves_equal(port_state, jax_state):
    got = [port_state.params, port_state.opt_state, port_state.extra]
    want = [jax_state.params, jax_state.opt_state, jax_state.extra]
    g_leaves = [t for tree in got for t in _sorted_leaves(tree)]
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for a, b in zip(g_leaves, w_leaves):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    assert port_state.step == jax_state.step


def _sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree


def test_checkpoints_resume_across_the_packages(tmp_path):
    jst = _jax_state()
    fresh = _port_like(jst)
    # the reference writes, the port resumes
    jloop = JLoop(str(tmp_path / "j"), async_save=False)
    jloop.mgr.save(jst.step, JLoop._pack(jst))
    jloop.mgr.wait()
    got = FaultTolerantLoop(str(tmp_path / "j"),
                            async_save=False).resume_or_init(fresh)
    _assert_leaves_equal(got, jst)
    # the port writes (its loop's final save), the reference resumes
    loop = FaultTolerantLoop(str(tmp_path / "t"), async_save=False)
    loop.run(got, None, iter(()), total_steps=got.step)
    back = JLoop(str(tmp_path / "t"), async_save=False).resume_or_init(
        lambda: JState(params=jax.tree.map(jnp.zeros_like, jst.params),
                       opt_state=jax.tree.map(jnp.zeros_like, jst.opt_state),
                       step=0,
                       extra=jax.tree.map(jnp.zeros_like, jst.extra)))
    _assert_leaves_equal(got, back)


def test_emergency_save_and_refusals(tmp_path):
    loop, fresh, _, _ = _setup(tmp_path)
    st = fresh()
    st.step = 9
    loop._state = st
    with pytest.raises(SystemExit) as exc:
        loop._emergency(signal.SIGTERM, None)
    assert exc.value.code == 128 + signal.SIGTERM
    assert loop.mgr.latest_step() == 9
    assert loop.resume_or_init(fresh).step == 9
    # no placement: the whole state, as without shardings
    assert loop.resume_or_init(fresh, shardings={"params": None}).step == 9
    packed = FaultTolerantLoop._pack(TrainLoopState(
        params={"w": torch.ones(3)}, opt_state={"m": torch.zeros(3)},
        step=9))
    assert int(packed["step"]) == 9 and "params" in packed
