"""zamba2-2.7b (Mamba2 SSD blocks and one shared attention block) on the
port against the JAX package, on the CPU: the chunked SSD scan with and
without a carried state on a length that is not a multiple of the chunk,
the Mamba2 block's three branches (no state, stateful prefill, the
one-token recurrence), then the reduced entry through the zoo's checks
(``tests/_torch_zoo.py``: specs, emulate and deploy logits, the
reference's artifact on the port, deploy == emulate, decode against the
reference's decode, decode against the forward without CIM, engine
tokens).

Inputs are made with numpy from a seed; the block's params are the
reference's own (JAX ``init_params`` carried across by ``interop``). The
scans agree within 1e-5, the blocks' outputs within the logits' 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro.models import mamba2 as JM
from repro_torch.interop import from_numpy_tree
from repro_torch.models import mamba2 as TM

ARCH = "zamba2-2.7b"
B = zoo.B
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def reference():
    return zoo.make_reference(ARCH)


def _ssd_inputs(rng, b=2, L=21, H=4, P=8, G=1, N=6):
    f = np.float32
    return dict(
        x=rng.standard_normal((b, L, H, P)).astype(f),
        dt=(rng.random((b, L, H)) * 0.2 + 0.01).astype(f),
        A=-(rng.random(H) * 3 + 0.5).astype(f),
        B=rng.standard_normal((b, L, G, N)).astype(f),
        C=rng.standard_normal((b, L, G, N)).astype(f),
        D=rng.standard_normal(H).astype(f))


@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_matches_reference(carried):
    """21 positions in chunks of 8 (the last one padded), from zero or from
    a carried (b, H, N, P) state: outputs and final states at 1e-5."""
    rng = np.random.default_rng(3 + carried)
    inp = _ssd_inputs(rng)
    s0 = (rng.standard_normal((2, 4, 6, 8)).astype(np.float32) if carried
          else None)
    want_y, want_s = jax.jit(
        lambda i, s: JM.ssd_chunked(i["x"], i["dt"], i["A"], i["B"], i["C"],
                                    i["D"], 8, initial_state=s))(
        {k: jnp.asarray(v) for k, v in inp.items()},
        None if s0 is None else jnp.asarray(s0))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got_y, got_s = TM.ssd_chunked(
        t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], 8,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("branch", ["stateless", "prefill", "step"])
def test_apply_mamba2_branches_match_reference(reference, branch):
    """The block on layer 0's params: without a state (train and prefill),
    a stateful prefill of 11 positions from a carried state, and the
    one-token recurrence. Outputs at 1e-4, the new conv and SSD states at
    1e-5."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    p_np = jax.tree.map(lambda a: a[0], reference["params"]["mamba_layers"])
    rng = np.random.default_rng({"stateless": 0, "prefill": 1, "step": 2}[
        branch])
    L = 1 if branch == "step" else 11
    x = rng.standard_normal((B, L, tcfg.d_model)).astype(np.float32)
    st = None
    if branch != "stateless":
        s = {k: np.asarray(v) for k, v in
             JM.init_mamba_state(jcfg, B).items()}
        st = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.5
              for k, v in s.items()}
    y_j, ns_j = jax.jit(lambda p, x_, s: JM.apply_mamba2(p, x_, jcfg,
                                                         state=s))(
        p_np, jnp.asarray(x),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    y_t, ns_t = TM.apply_mamba2(
        from_numpy_tree(p_np, zoo.CPU), torch.from_numpy(x), tcfg,
        state=None if st is None else {k: torch.from_numpy(v.copy())
                                       for k, v in st.items()})
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               **zoo.LOGIT_TOL)
    assert (ns_t is None) == (ns_j is None)
    if ns_t is not None:
        for k in ("conv", "ssd"):
            np.testing.assert_allclose(ns_t[k].numpy(), np.asarray(ns_j[k]),
                                       **TOL)


def test_init_cache_matches_reference():
    """The stacked Mamba2 states and the shared block's per-application KV
    caches, as the reference's ``init_cache``."""
    from repro.models.registry import get_model as j_get_model
    from repro_torch.models.registry import get_model
    jcfg, tcfg = zoo.cfgs(ARCH)
    want = j_get_model(jcfg).init_cache(jcfg, 3, 20)
    got = get_model(tcfg).init_cache(tcfg, 3, 20, device=zoo.CPU)
    for part in ("mamba", "attn"):
        assert set(got[part]) == set(want[part])
        for f, w in want[part].items():
            assert tuple(got[part][f].shape) == w.shape, (part, f)
            assert str(got[part][f].dtype).replace("torch.", "") == \
                w.dtype.name, (part, f)


@pytest.mark.parametrize("mode,pack_dtype", [("emulate", "int8"),
                                             ("deploy", "int4")])
def test_specs_match_reference(mode, pack_dtype):
    zoo.check_specs(ARCH, mode, pack_dtype)


def test_emulate_and_deploy_match_reference(reference):
    zoo.check_emulate_and_deploy(reference)


@pytest.mark.parametrize("mode", ["emulate", "deploy"])
def test_decode_matches_reference_decode(reference, mode):
    zoo.check_decode_matches_reference(reference, mode)


def test_decode_matches_forward_without_cim(reference):
    zoo.check_decode_matches_forward_without_cim(reference)


def test_engine_serves_the_reference_engines_tokens(reference):
    zoo.check_engine_tokens(reference)
