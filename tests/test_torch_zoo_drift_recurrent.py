"""zamba2 and xlstm (Mamba2 SSD stacks with a shared attention block,
mLSTM/sLSTM blocks) on a drifting chip, on the port against the JAX
package, on the CPU, through the checks of ``tests/_torch_zoo_drift.py``:
the drifting engine's tokens and every invocation's logits against the
reference's on its own fields, and drifted deploy equal to drifted
emulate within the port. Stacked nodes drift over their whole (layer,
split, tile, row, column) planes, as the reference's ``drift_tree``
draws them.
"""
import pytest

import _torch_zoo_drift as zd


@pytest.fixture(scope="module", params=("zamba2-2.7b", "xlstm-1.3b"))
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
    if ref["arch"] == "zamba2-2.7b":
        assert "/shared_attn/attn/wq/w_digits" in drifted
        assert "/mamba_layers/in_proj/w_digits" in drifted
