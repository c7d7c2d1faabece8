"""xlstm-1.3b (mLSTM and sLSTM blocks) on the port against the JAX
package, on the CPU: the stabilized chunkwise mLSTM with a carried (C, n,
m) state and with padding (the -1e30 input-gate pad and the masked
exponentials stay finite), a one-token step padded to a whole chunk, the
sLSTM block from zero and from a carried state, then the reduced entry
through the zoo's checks (``tests/_torch_zoo.py``).

Inputs are made with numpy from a seed; the blocks' params are the
reference's own. The scans agree within 1e-5, the blocks' outputs within
the logits' 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro.models import xlstm as JX
from repro_torch.interop import from_numpy_tree
from repro_torch.models import xlstm as TX

ARCH = "xlstm-1.3b"
B = zoo.B
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def reference():
    return zoo.make_reference(ARCH)


def _carry(rng, b, H, hd):
    return (rng.standard_normal((b, H, hd, hd)).astype(np.float32),
            rng.standard_normal((b, H, hd)).astype(np.float32),
            rng.standard_normal((b, H)).astype(np.float32))


@pytest.mark.parametrize("L,carried", [(21, False), (21, True), (1, True),
                                       (16, False)])
def test_mlstm_chunked_matches_reference(L, carried):
    """Chunks of 8: 21 positions (padded), one position (a decode step,
    padded to a whole chunk) and 16 (no padding), from zero or from a
    carried state: outputs and the final (C, n, m) at 1e-5, all finite."""
    b, H, hd = 2, 2, 8
    rng = np.random.default_rng(L + 100 * carried)
    q, k, v = (rng.standard_normal((b, L, H, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((b, L, H)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-rng.standard_normal((b, L, H))
                                - 2))).astype(np.float32)
    carry = _carry(rng, b, H, hd) if carried else None
    want_y, want_c = jax.jit(lambda *a: JX._mlstm_chunked(*a[:5], 8, a[5]))(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)),
        None if carry is None else tuple(jnp.asarray(c) for c in carry))
    got_y, got_c = TX._mlstm_chunked(
        *(torch.from_numpy(a) for a in (q, k, v, li, lf)), 8,
        None if carry is None else tuple(torch.from_numpy(c)
                                         for c in carry))
    assert bool(torch.isfinite(got_y).all())
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("carried", [False, True])
def test_apply_slstm_matches_reference(reference, carried):
    """The sLSTM block (token loop, exponential gating, GeGLU FFN with the
    tanh GELU) on the reduced entry's sLSTM params: 9 positions from the
    zero state, or from a carried one. Output at 1e-4, the new h/c/n/m at
    1e-5."""
    jcfg, tcfg = zoo.cfgs(ARCH)
    p_np = jax.tree.map(lambda a: a[0], reference["params"]["slstm_layers"])
    rng = np.random.default_rng(7 + carried)
    x = rng.standard_normal((B, 9, tcfg.d_model)).astype(np.float32)
    st = None
    if carried:
        nh = tcfg.ssm.n_slstm_heads
        shape = (B, nh, tcfg.d_model // nh)
        st = {"h": rng.standard_normal(shape), "c": rng.standard_normal(shape),
              "n": rng.random(shape) + 0.5, "m": rng.standard_normal(shape)}
        st = {k: v.astype(np.float32) for k, v in st.items()}
    y_j, ns_j = jax.jit(lambda p, x_, s: JX.apply_slstm(p, x_, jcfg,
                                                        state=s))(
        p_np, jnp.asarray(x),
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()})
    y_t, ns_t = TX.apply_slstm(
        from_numpy_tree(p_np, zoo.CPU), torch.from_numpy(x), tcfg,
        state=None if st is None else {k: torch.from_numpy(v.copy())
                                       for k, v in st.items()})
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               **zoo.LOGIT_TOL)
    if carried:
        for k in ("h", "c", "n", "m"):
            np.testing.assert_allclose(ns_t[k].numpy(), np.asarray(ns_j[k]),
                                       **TOL)


def test_init_cache_matches_reference():
    """The mLSTM conv and (C, n, m) cell states and the sLSTM h/c/n/m, as
    the reference's ``init_cache``, values included (n 1e-6, m -1e30)."""
    from repro.models.registry import get_model as j_get_model
    from repro_torch.models.registry import get_model
    jcfg, tcfg = zoo.cfgs(ARCH)
    want = j_get_model(jcfg).init_cache(jcfg, 3, 20)
    got = get_model(tcfg).init_cache(tcfg, 3, 20, device=zoo.CPU)
    pairs = ([(got["mlstm"]["conv"], want["mlstm"]["conv"])]
             + list(zip(got["mlstm"]["cell"], want["mlstm"]["cell"]))
             + [(got["slstm"][k], want["slstm"][k]) for k in "hcnm"])
    for g, w in pairs:
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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
