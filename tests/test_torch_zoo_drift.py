"""whisper and llava (the conv front ends) on a drifting chip, on the
port against the JAX package, on the CPU, through the checks of
``tests/_torch_zoo_drift.py`` (the drifting engine's tokens and every
invocation's logits against the reference's on its own fields, drifted
deploy equal to drifted emulate within the port, the front-end convs'
planes drifted too). whisper's repaired ``generate_batch`` is held
against the reference's lockstep run with the encoder states in its
cache, its drifting slot engine against the reference's.

zamba2 and xlstm are in ``tests/test_torch_zoo_drift_recurrent.py``;
whisper's ``generate_batch`` without encoder states, its recalibration
and its fallback in ``tests/test_torch_whisper_serving.py``.
"""
import pytest

import _torch_zoo_drift as zd


@pytest.fixture(scope="module", params=("whisper-small",
                                        "llava-next-mistral-7b"))
def ref(request):
    return zd.make_reference(request.param)


@pytest.fixture(scope="module")
def port(ref):
    return zd.make_port(ref)


def test_drifting_engine_gives_the_references_tokens(port, ref):
    zd.check_engine_tokens(port, ref)


def test_drifted_logits_per_invocation(port, ref):
    zd.check_logits_per_invocation(port, ref)


def test_drifted_deploy_equals_drifted_emulate(port, ref):
    zd.check_deploy_equals_emulate(port, ref)


def test_drift_tree_reaches_the_references_nodes(port, ref):
    drifted = zd.check_drift_tree_reaches_the_references_nodes(port, ref)
    convs = {"whisper-small": {"/frontend/conv1/w_digits",
                               "/frontend/conv2/w_digits"},
             "llava-next-mistral-7b": {"/patch_embed/w_digits"}}
    assert convs[ref["arch"]] <= set(drifted)
