"""What ``correct`` has to catch, on the CPU at a small size: the control
(the reference one precision lower, TF32, in the program's place)
and the timed path broken underneath a whole run."""
import pytest
import torch

from perfbench import harness

from ._cpu_cells import context, numbers


def _run(ctx):
    result, _ = harness.run(ctx)
    return result


@pytest.mark.parametrize("cell", ["resnet20.eval", "resnet20.variation"])
def test_eval_control_fails_the_limit(cell):
    ctx = context(cell)
    got = numbers(ctx, control=True)
    assert got["logit_gap"] <= ctx.cell["limits"]["logit_gap"]
    assert got["control.logit_gap"] > ctx.cell["limits"]["logit_gap"]


def test_eval_answer_altered_is_not_correct(monkeypatch):
    from repro_torch.models import resnet
    forward = resnet.forward

    def altered(*a, **kw):
        logits, state = forward(*a, **kw)
        return logits + torch.nn.functional.one_hot(
            torch.tensor(0), logits.shape[-1]).to(logits), state
    ctx = context("resnet20.eval")
    assert _run(ctx)["correct"] is True
    monkeypatch.setattr(resnet, "forward", altered)
    assert _run(context("resnet20.eval"))["correct"] is False


def _qat(**kw):
    return context("resnet18.qat", config="resnet20-cifar10",
                   checked_steps=1, **kw)


def test_qat_control_fails_a_limit():
    ctx = _qat()
    got = numbers(ctx, control=True)
    limits = ctx.cell["limits"]
    assert all(got[k] <= v for k, v in limits.items())
    assert any(got[f"control.{k}"] > v for k, v in limits.items())


def _unchanged(step):
    def run(params, state, mom, xb, yb, lr, cfg, device):
        _, _, _, loss = step(params, state, mom, xb, yb, lr, cfg, device)
        return params, state, mom, loss
    return run


def _half_batch(step):
    def run(params, state, mom, xb, yb, lr, cfg, device):
        n = len(xb) // 2
        return step(params, state, mom, xb[:n], yb[:n], lr, cfg, device)
    return run


def _loss_altered(step):
    def run(params, state, mom, xb, yb, lr, cfg, device):
        params, state, mom, loss = step(params, state, mom, xb, yb, lr, cfg,
                                        device)
        return params, state, mom, loss * 1.001
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _loss_altered])
def test_qat_fault_is_not_correct(monkeypatch, fault):
    from repro_torch.train import qat
    monkeypatch.setattr(qat, "qat_step", fault(qat.qat_step))
    assert _run(_qat())["correct"] is False
