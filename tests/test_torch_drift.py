"""The port's drift model (DESIGN.md §11) against the JAX package's, on
the CPU.

Randomness does not cross frameworks, so the fields come from a drift
source that hands in the JAX package's own draws
(``_torch_drift_source.JaxDriftSource``). The composed drift factor then
matches ``repro.core.variation.drift_field`` at rtol 1e-6 (the two
libraries' ``exp`` may differ by an ulp); ``drift_tree`` perturbs exactly
the reference's nodes; layer outputs under drift match the reference at
1e-4, and within the port deploy equals emulate bit for bit. The
Monte-Carlo drift sweep is held in ``test_torch_drift_sweep.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_drift_source import JaxDriftSource
from repro import api as japi
from repro.core import variation as jvar
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro_torch import api as tapi
from repro_torch.core import variation as tvar
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree

CPU = "cpu"
# the schedule of tests/test_drift.py::_sched and its components
SCHED = dict(read_sigma=0.02, read_rate=0.0, cell_rate=2e-4, col_rate=1e-3)
COMPONENTS = {
    "read": dict(read_sigma=0.02, read_rate=1e-4),
    "cell": dict(cell_rate=2e-4),
    "col": dict(col_rate=1e-3),
    "composed": SCHED,
}
SHAPES = {"linear": (2, 3, 32, 16), "conv": (2, 2, 3, 3, 4, 10),
          "stacked": (3, 2, 2, 32, 16)}


def _scheds(**kw):
    return jvar.DriftSchedule(**kw), tvar.DriftSchedule(**kw)


@jax.jit
def _j_field(key, state, zeros):
    return jvar.drift_field(key, zeros.shape, state)


#: each component alone on linear planes, composed on every layout
FIELD_CASES = [(c, "linear") for c in ("read", "cell", "col")] + [
    ("composed", s) for s in sorted(SHAPES)]


@pytest.mark.parametrize("t", [0, 1, 300])
@pytest.mark.parametrize("comp,shape", FIELD_CASES)
def test_drift_field_matches_reference(comp, shape, t):
    js, ts = _scheds(**COMPONENTS[comp])
    key = jax.random.PRNGKey(3)
    want = np.asarray(_j_field(key, js.at(t), jnp.zeros(SHAPES[shape])))
    got = tvar.drift_field(JaxDriftSource(key), SHAPES[shape], ts.at(t))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if comp == "col":
        # one factor per (split, tile, column): the column form broadcasts
        assert tuple(got.shape) == tvar._column_field_shape(SHAPES[shape])


@pytest.mark.parametrize("comp", ["composed", "col"])
def test_apply_cell_variation_matches_reference(comp):
    js, ts = _scheds(**COMPONENTS[comp])
    key = jax.random.PRNGKey(8)
    d = np.random.RandomState(0).randint(-3, 4, SHAPES["linear"]).astype(
        np.float32)
    want = np.asarray(jax.jit(jvar.apply_cell_variation)(
        jnp.asarray(d), key, js.at(300)))
    got = tvar.apply_cell_variation(torch.from_numpy(d), JaxDriftSource(key),
                                    ts.at(300))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    planes = torch.from_numpy(d).to(torch.int8)
    assert tvar.apply_cell_variation(planes, JaxDriftSource(key),
                                     tvar.DriftSchedule().at(300)) is planes


def test_sampler_persistent_fields_persist_and_read_redraws():
    s = tvar.Sampler(5).for_layer(("blk", "0", "wq"))
    shape = SHAPES["linear"]
    sched = tvar.DriftSchedule(cell_rate=1e-3, col_rate=2e-3)
    l1 = torch.log(tvar.drift_field(s, shape, sched.at(100)))
    l2 = torch.log(tvar.drift_field(s, shape, sched.at(200)))
    np.testing.assert_allclose(l2.numpy(), 2.0 * l1.numpy(), rtol=1e-4,
                               atol=1e-6)
    assert torch.equal(s.cell(shape), s.cell(shape))
    assert torch.equal(s.col(shape), s.col(shape))
    # the read component redraws per t; another node draws another field
    assert not torch.equal(s.read(shape, 7), s.read(shape, 8))
    assert torch.equal(s.read(shape, 7), s.read(shape, 7))
    other = tvar.Sampler(5).for_layer(("blk", "0", "wk"))
    assert not torch.equal(s.cell(shape), other.cell(shape))
    # the same fields on the same seed, sample and node
    f = tvar.drift_field(s, shape, tvar.DriftSchedule(**SCHED).at(300))
    g = tvar.drift_field(tvar.Sampler(5).for_layer(("blk", "0", "wq")), shape,
                         tvar.DriftSchedule(**SCHED).at(300))
    assert torch.equal(f, g)


@pytest.mark.parametrize("path", [(), ("lin",), ("moe_layers", "attn", "wq"),
                                  ("layers", "3", "mlp", "wd")])
def test_path_hash_is_path_fold_keys(path):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(
        np.asarray(jax.random.fold_in(key, tvar.path_hash(path))),
        np.asarray(jvar.path_fold_key(key, path)))


def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                act_bits=6, psum_bits=4, array_rows=32, array_cols=32)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _linear(tc, seed=0, k=70, n=24, b=8):
    x = (np.random.RandomState(seed).randn(b, k) * 0.5).astype(np.float32)
    p = tapi.init_linear(torch.Generator().manual_seed(seed), k, n, tc,
                         device=CPU)
    return tapi.calibrate_linear(torch.from_numpy(x), p, tc), x


def _conv(tc, seed=0):
    x = (np.random.RandomState(seed).randn(2, 8, 8, 8) * 0.5).astype(
        np.float32)
    p = tapi.init_conv(torch.Generator().manual_seed(seed), 3, 3, 8, 16, tc,
                       device=CPU)
    return tapi.calibrate_conv(torch.from_numpy(x), p, tc), x


def test_zero_schedule_returns_the_same_tree():
    _, tc = _cfgs()
    p, _ = _linear(tc)
    tree = {"lin": tapi.pack_linear(p, tc.replace(mode="deploy"))}
    out = tvar.drift_tree(tree, tvar.Sampler(0),
                          tvar.DriftSchedule().at(500))
    assert out is tree and out["lin"]["w_digits"] is tree["lin"]["w_digits"]
    assert not tvar.variation_wanted(tvar.Sampler(0),
                                     tvar.DriftSchedule().at(500))


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_drifted_deploy_equals_emulate_and_matches_reference(kind,
                                                             pack_dtype):
    jc, tc = _cfgs(pack_dtype=pack_dtype)
    p, x = (_linear if kind == "linear" else _conv)(tc)
    p_np = to_numpy_tree(p)
    vk = jax.random.PRNGKey(42)
    js, ts = _scheds(**SCHED)
    src = JaxDriftSource(vk)
    fwd = tapi.linear if kind == "linear" else tapi.conv2d
    y_em = fwd(torch.from_numpy(x), p, tc, variation=src,
               variation_std=ts.at(250), compute_dtype=torch.float32)
    dc = tc.replace(mode="deploy")
    packed = (tapi.pack_linear if kind == "linear" else tapi.pack_conv)(p, dc)
    y_dep = fwd(torch.from_numpy(x), packed, dc, variation=src,
                variation_std=ts.at(250), compute_dtype=torch.float32)
    assert torch.equal(y_dep, y_em)
    clean = fwd(torch.from_numpy(x), packed, dc, compute_dtype=torch.float32)
    assert not torch.equal(clean, y_dep)

    jfwd = japi.linear if kind == "linear" else japi.conv2d
    jp = jax.tree.map(jnp.asarray, p_np)
    want = jax.jit(lambda p_, x_, st: jfwd(
        x_, p_, jc, variation_key=vk, variation_std=st,
        compute_dtype=jnp.float32))(jp, jnp.asarray(x), js.at(250))
    np.testing.assert_allclose(y_em.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_drift_tree_perturbs_the_reference_nodes():
    """On the reduced moonshot pack: the same nodes drift (the attention,
    dense MLP and shared-expert linears), the routed MoE banks pass
    through as the same objects, and the drifted planes match the
    reference's."""
    from repro.configs.registry import get_config as j_get_config
    from repro.models.registry import get_model as j_get_model
    from repro.nn import init_params as j_init_params
    cim = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
               act_bits=8, psum_bits=6, array_rows=32, array_cols=32,
               pack_dtype="int4")
    jcfg = j_get_config("moonshot-v1-16b-a3b", reduced=True,
                        cim=JCIMConfig(**cim)).replace(
        compute_dtype="float32", remat=False)
    params = jax.jit(lambda k: j_init_params(
        j_get_model(jcfg).specs(jcfg), k))(jax.random.PRNGKey(0))
    packed = jax.jit(lambda p: japi.pack_model(p, jcfg.cim))(params)
    key = jax.random.PRNGKey(7)
    js, ts = _scheds(**SCHED)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda p, st: jvar.drift_tree(p, key, st))(packed, js.at(300)))
    tp = from_numpy_tree(jax.tree.map(np.asarray, packed), CPU)
    got = tvar.drift_tree(tp, JaxDriftSource(key), ts.at(300))

    drifted = []

    def walk(g, w, t, path):
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], t[k], path + (k,))
            return
        if w.dtype == np.float32 and path[-1] == "w_digits":
            drifted.append("/".join(path))
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
        else:
            assert g is t, path      # passed through as the same object
    walk(got, want, tp, ())
    assert sorted(drifted) == sorted(
        "/".join(p) for p in _w_digit_paths(tp))
    assert any("shared" in d for d in drifted)
    assert not any(d.endswith(("wg_digits", "wu_digits", "wd_digits"))
                   for d in drifted)


def _w_digit_paths(tree, path=()):
    if isinstance(tree, dict):
        if "w_digits" in tree:
            yield path + ("w_digits",)
            return
        for k, v in tree.items():
            yield from _w_digit_paths(v, path + (k,))
