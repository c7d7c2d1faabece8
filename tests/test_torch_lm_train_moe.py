"""The port's LM train step against the JAX package on the MoE
transformer of the zoo (moonshot-v1-16b-a3b) at its reduced config, CIM
off, and under CIM emulate on a batch that leaves experts without tokens:
the routing gradients (ROADMAP item 6's gate). Cases and tolerances:
``tests/_torch_lm_train.py``.
"""
import pytest

from _torch_lm_train import (LM_CIM, check_against_reference, configs,
                             reference_step, stream_batch)
from repro_torch.models import layers

ARCHS = ("moonshot-v1-16b-a3b",)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_step_match_reference(arch):
    check_against_reference(arch, reference_step(arch))


def test_routing_gradients_match_reference(monkeypatch):
    """moonshot under CIM emulate on 2 tokens (4 routed pairs over 8
    experts): the loss, every gradient and the step against the
    reference, and, in the port, each expert that the router gave
    tokens has nonzero gradients on its weights and its column scales in
    every bank while each expert it gave none has zero ones (the
    reference's are zero there too: ``assert_tree_close`` takes a zero
    leaf exactly)."""
    counts = []
    orig = layers.route

    def route(logits, cfg):
        out = orig(logits, cfg)
        counts.append(layers.expert_counts(out[2], cfg.moe.n_experts,
                                           out[3]))
        return out
    monkeypatch.setattr(layers, "route", route)
    jcfg, _ = configs("moonshot-v1-16b-a3b", LM_CIM)
    ref = reference_step("moonshot-v1-16b-a3b", LM_CIM,
                         batch=stream_batch(jcfg, b=1, t=2))
    grads = check_against_reference("moonshot-v1-16b-a3b", ref, LM_CIM)
    routed = counts[0] > 0
    assert 0 < int(routed.sum()) < routed.numel()
    moe = grads["moe_layers"]["moe"]
    for nm in ("wg", "wu", "wd"):
        for key in (nm, f"{nm}_s_w", f"{nm}_s_p"):
            g = moe[key][0]
            live = g.reshape(g.shape[0], -1).abs().amax(dim=1) > 0
            assert bool((live == routed).all()), (key, live, routed)
