"""The port's LM train step against the JAX package on the recurrent and
multimodal entries of the zoo (xlstm-1.3b, zamba2-2.7b, whisper-small,
llava-next-mistral-7b) at their reduced configs, CIM off, with the front
ends' input at ``frontend_input_shape`` (whisper's raw log-mel frames
through its conv stem, llava's images through its patch-embed conv, whose
positions the loss drops). Cases and tolerances:
``tests/_torch_lm_train.py``.
"""
import pytest

from _torch_lm_train import check_against_reference, reference_step

ARCHS = ("xlstm-1.3b", "zamba2-2.7b", "whisper-small",
         "llava-next-mistral-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_step_match_reference(arch):
    grads = check_against_reference(arch, reference_step(arch))
    if arch == "whisper-small":
        assert float(grads["frontend"]["conv1"]["w"].abs().max()) > 0
    if arch == "llava-next-mistral-7b":
        assert float(grads["patch_embed"]["w"].abs().max()) > 0
