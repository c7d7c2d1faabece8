"""The port's LM train step against the JAX package on the dense
transformers of the zoo (qwen3-0.6b, llama3-8b, granite-8b, olmo-1b) at
their reduced configs, CIM off; qwen3 under CIM emulate at
``tests/test_models.py::test_cim_enabled_lm_trains``'s config with the LSQ
scales' gradients; and gradient accumulation. Cases and tolerances:
``tests/_torch_lm_train.py``.
"""
import numpy as np
import pytest
import torch

from _torch_lm_train import (CPU, LM_CIM, RUN, check_against_reference,
                             configs, port_batch, reference_step,
                             stream_batch)
from repro_torch import tree_leaves
from repro_torch.configs.base import RunConfig
from repro_torch.models.registry import get_model
from repro_torch.nn.module import init_params
from repro_torch.train.trainer import make_train_step

ARCHS = ("qwen3-0.6b", "llama3-8b", "granite-8b", "olmo-1b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_step_match_reference(arch):
    check_against_reference(arch, reference_step(arch))


def test_cim_emulate_step_matches_reference_with_scale_gradients():
    """qwen3 under column-wise CIM emulate: the weights' and the three LSQ
    scales' gradients of every CIM linear, and the step after them."""
    grads = check_against_reference(
        "qwen3-0.6b", reference_step("qwen3-0.6b", LM_CIM), LM_CIM)
    attn = grads["layers"]["attn"]["wq"]
    assert {"w", "s_w", "s_p", "s_a"} <= set(attn)
    assert all(float(attn[k].abs().max()) > 0 for k in ("s_w", "s_p", "s_a"))


def _first_moments(tcfg, accum):
    """AdamW's first moment after one step (m = 0.1 g: clipping off) and
    the loss, with ``accum`` microbatches."""
    model = get_model(tcfg)
    params = init_params(model.specs(tcfg), 0, device=CPU)
    init_state, step = make_train_step(model, tcfg, RunConfig(
        **RUN, accum_steps=accum, grad_clip=0.0))
    _, state, m = step(params, init_state(params),
                       port_batch(stream_batch(tcfg)))
    return float(m["loss"]), state["m"]


def test_accumulation_equals_one_batch():
    """``accum_steps=2`` (two microbatches, gradients summed in float32
    and halved) against the whole batch at once, CIM off: the loss, and
    the gradients through AdamW's first moment, within 1e-5 of each
    leaf's largest magnitude: the float32 reordering of the sums over B x
    T = 32 rows (at most about 32 x 2^-24 = 2e-6 of the summed
    magnitudes) with a margin of 5. A batch that does not split raises,
    as the reference's assertion does."""
    _, tcfg = configs("qwen3-0.6b")
    loss1, m1 = _first_moments(tcfg, 1)
    loss2, m2 = _first_moments(tcfg, 2)
    np.testing.assert_allclose(loss2, loss1, rtol=1e-6)
    for a, b in zip(tree_leaves(m2), tree_leaves(m1)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    with pytest.raises(AssertionError):
        _first_moments(tcfg, 3)


def test_accumulation_scales_the_psum_scale_gradient_as_the_reference():
    """Under CIM emulate the LSQ gradient scale g = 1/sqrt(n q_p) of a
    partial-sum scale counts the batch's rows in n, so two microbatches
    give s_p sqrt(2) times the whole batch's gradient; the reference's
    ``make_train_step`` does the same (1.4142135, ROADMAP fault 18). The
    weights' and the weight scales' gradients agree as above."""
    _, tcfg = configs("qwen3-0.6b", LM_CIM)
    m1 = _first_moments(tcfg, 1)[1]["layers"]
    m2 = _first_moments(tcfg, 2)[1]["layers"]
    for nm in ("wq", "wo"):
        node1, node2 = m1["attn"][nm], m2["attn"][nm]
        ratio = float(node2["s_p"].abs().max() / node1["s_p"].abs().max())
        np.testing.assert_allclose(ratio, np.sqrt(2.0), rtol=1e-4)
        for k in ("w", "s_w"):
            err = float((node2[k] - node1[k]).abs().max())
            assert err <= 1e-5 * float(node1[k].abs().max()), (nm, k)


def test_fsdp_and_deploy_trees_are_refused():
    """``RunConfig(fsdp=True)`` is a placement: without a mesh its step is
    the plain one, bit for bit (the mesh runs are
    ``tests/test_torch_fsdp.py``); a deploy tree's integer digit planes
    have no gradient (the reference's ``jax.value_and_grad`` raises
    TypeError on them too)."""
    _, tcfg = configs("qwen3-0.6b")
    model = get_model(tcfg)
    params = init_params(model.specs(tcfg), 0, device=CPU)
    batch = port_batch(stream_batch(tcfg))
    outs = []
    for fsdp in (False, True):
        init_state, step = make_train_step(model, tcfg,
                                           RunConfig(**RUN, fsdp=fsdp))
        outs.append(step(params, init_state(params), batch))
    assert torch.equal(outs[0][2]["loss"], outs[1][2]["loss"])
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        assert torch.equal(a, b)
    dcfg = tcfg.replace(cim=configs("qwen3-0.6b", LM_CIM)[1].cim.replace(
        mode="deploy"))
    dmodel = get_model(dcfg)
    params = init_params(dmodel.specs(dcfg), 0, device=CPU)
    init_state, step = make_train_step(dmodel, dcfg, RunConfig(**RUN))
    with pytest.raises(TypeError, match="int8"):
        step(params, init_state(params), port_batch(stream_batch(dcfg)))
