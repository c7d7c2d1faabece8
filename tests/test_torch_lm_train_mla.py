"""The port's LM train step against the JAX package on deepseek-v3-671b
at its reduced config (MLA attention with its low-rank query and latent
key-value projections, a leading dense layer and MoE layers), CIM off.
Cases and tolerances: ``tests/_torch_lm_train.py``.
"""
import pytest

from _torch_lm_train import check_against_reference, reference_step

ARCHS = ("deepseek-v3-671b",)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_step_match_reference(arch):
    check_against_reference(arch, reference_step(arch))
