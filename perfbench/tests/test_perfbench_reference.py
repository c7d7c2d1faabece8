"""The plain reference against the port on the CPU at a small batch: one
eval forward, one varied forward, one QAT step."""
import pytest

from ._cpu_cells import context, numbers


@pytest.mark.parametrize("cell", ["resnet20.eval", "resnet20.variation",
                                  "resnet18.eval"])
def test_eval_logits_match_the_port(cell):
    # on the CPU the port runs its kernels' plain versions, in float32
    # without TF32, as the reference does: the logits agree to round-off
    assert numbers(context(cell))["logit_gap"] < 1e-5


def test_qat_step_matches_the_port():
    got = numbers(context("resnet18.qat", config="resnet20-cifar10",
                          checked_steps=1))
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-4
    assert got["bn_gap"] < 1e-4
