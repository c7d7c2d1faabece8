"""The conv layer of the zoo's front ends (``models.layers.conv_specs`` and
``apply_conv``) on the port against the JAX package, on the CPU, at the
front ends' shapes: whisper's 1x3 stem convs on H = 1 images at stride 1
and 2 (SAME, even and odd widths: XLA pads (0, 1) at stride 2 on an even
width), and a patch-embed conv whose taps exceed the array's rows (4x4
taps on 8-row arrays: c_per_array 1, tiles of 16 rows, the small copy of
llava's 196-row tiles at patch 14 on 128-row arrays).

Spec trees agree in shapes and dtypes on every backend geometry; the
packs (int8, and int4 nibble pairs where c_per_array is even) are byte
for byte the reference's; off, emulate and deploy outputs agree with the
reference's at 1e-4 (off at 1e-5), and within the port deploy equals
emulate bit for bit. Params are made by the JAX package (init, then
calibrated on the input) and carried across as numpy; inputs come from
numpy's seeded generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.models import layers as JL
from repro_torch import api as tapi
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import layers as TL

CPU = "cpu"
TOL = dict(rtol=1e-4, atol=1e-4)

# (kh, kw, C_in, C_out, H, W, stride, padding, array rows)
CASES = {
    "stem1": (1, 3, 16, 24, 1, 48, 1, "SAME", 32),
    "stem2-even": (1, 3, 24, 24, 1, 48, 2, "SAME", 32),
    "stem2-odd": (1, 3, 24, 24, 1, 47, 2, "SAME", 32),
    "patch": (4, 4, 3, 16, 16, 16, 4, "VALID", 8),
}


def _cfgs(rows, **kw):
    base = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                act_bits=8, psum_bits=6, array_rows=rows, array_cols=rows)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _leaves(tree, path=""):
    if not isinstance(tree, dict):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{path}/{k}")


def _dtype(d):
    if isinstance(d, torch.dtype) or d == "int4":
        return str(d if d != "int4" else torch.int8).replace("torch.", "")
    name = np.dtype(d).name
    return "int8" if name == "int4" else name


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode,pack_dtype", [
    ("emulate", "int8"), ("deploy", "int8"), ("deploy", "int4"),
    ("binary", "int8")])
def test_conv_specs_match_reference(case, mode, pack_dtype):
    """Names, shapes and dtypes of the spec tree: the HWIO weight and its
    scales, or the 6-D planes (nibble rows where c_per_array is even under
    int4), ``w_occ`` and the scales in the backend's plane geometry."""
    kh, kw, c_in, c_out, *_, rows = CASES[case]
    jc, tc = _cfgs(rows, mode=mode, pack_dtype=pack_dtype)
    want = dict(_leaves(JL.conv_specs(kh, kw, c_in, c_out, cim=jc,
                                      out_axis="embed")))
    got = dict(_leaves(TL.conv_specs(kh, kw, c_in, c_out, cim=tc,
                                     out_axis="embed")))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype(got[k].dtype) == _dtype(w.dtype), k
        assert tuple(got[k].pspec) == tuple(w.pspec), k


def _setup(case, jc):
    """The case's input (numpy, seed 0) and params made by the JAX package
    (``init_conv`` from a key, calibrated on the input), as numpy."""
    kh, kw, c_in, c_out, h, w, stride, padding, _ = CASES[case]
    x = (np.random.default_rng(0).standard_normal((2, h, w, c_in))
         ).astype(np.float32)
    p = jax.jit(lambda k, x_: japi.calibrate_conv(
        x_, japi.init_conv(k, kh, kw, c_in, c_out, jc), jc, stride=stride,
        padding=padding))(jax.random.PRNGKey(1), x)
    return x, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_apply_conv_matches_reference(case, pack_dtype):
    """The pack byte for byte the reference's; emulate and deploy (the
    reference's deploy on its Pallas conv kernel, interpreted) at 1e-4;
    the port's deploy equal to its emulate; the reference's pack served
    on the port at 1e-4."""
    kh, kw, c_in, c_out, h, w, stride, padding, rows = CASES[case]
    jc, tc = _cfgs(rows, pack_dtype=pack_dtype)
    x, p_np = _setup(case, jc)
    geo = dict(stride=stride, padding=padding)
    jd = jc.replace(mode="deploy")

    @jax.jit
    def jax_side(p, x_):
        packed = japi.pack_conv(p, jc)
        return (JL.apply_conv(p, x_, jc, compute_dtype=jnp.float32, **geo),
                packed,
                JL.apply_conv(packed, x_, jd, compute_dtype=jnp.float32,
                              **geo))

    y_je, packed_j, y_jd = jax.tree.map(np.asarray, jax_side(p_np, x))
    tp, xt = from_numpy_tree(p_np, CPU), torch.from_numpy(x)
    packed_t = tapi.pack_conv(tp, tc)
    got_pack = to_numpy_tree(packed_t)
    assert set(got_pack) == set(packed_j)
    for k, r in packed_j.items():
        r = r.astype(np.int8) if r.dtype.name == "int4" else r
        assert got_pack[k].dtype == r.dtype and got_pack[k].shape == r.shape
        np.testing.assert_array_equal(got_pack[k], r, err_msg=k)
    cpa_stored = packed_j["w_digits"].shape[4]
    assert packed_j["w_digits"].shape[:4] == (2, -(-c_in // max(
        1, rows // (kh * kw))), kh, kw)
    if case == "patch":
        assert cpa_stored == 1                  # tiles of kh*kw = 16 rows

    y_te = TL.apply_conv(tp, xt, tc, compute_dtype=torch.float32, **geo)
    np.testing.assert_allclose(y_te.numpy(), y_je, **TOL)
    td = tc.replace(mode="deploy")
    y_td = TL.apply_conv(packed_t, xt, td, compute_dtype=torch.float32,
                         **geo)
    np.testing.assert_array_equal(y_td.numpy(), y_te.numpy())
    y_tj = TL.apply_conv(from_numpy_tree(packed_j, CPU), xt, td,
                         compute_dtype=torch.float32, **geo)
    np.testing.assert_allclose(y_tj.numpy(), y_jd, **TOL)
    np.testing.assert_array_equal(y_tj.numpy(), y_td.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_conv_without_cim_matches_reference(case):
    """CIM off: the plain conv with XLA's SAME/VALID pads at 1e-5."""
    kh, kw, c_in, c_out, h, w, stride, padding, _ = CASES[case]
    jc, tc = _cfgs(8, enabled=False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, h, w, c_in)).astype(np.float32)
    p = {"w": (rng.standard_normal((kh, kw, c_in, c_out)) * 0.2).astype(
        np.float32)}
    want = JL.apply_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc,
                         stride=stride, padding=padding,
                         compute_dtype=jnp.float32)
    got = TL.apply_conv(from_numpy_tree(p, CPU), torch.from_numpy(x), tc,
                        stride=stride, padding=padding,
                        compute_dtype=torch.float32)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
