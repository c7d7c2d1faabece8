"""The port's hardware-style backends (``adc_free``, ``binary``) against the
JAX package's, on the CPU.

adc_free: the port's ADC-free kernels (plain versions on the CPU) against
``cim_matmul_adc_free_pallas`` / ``cim_conv_adc_free_pallas`` in
interpret mode and against the reference's oracle, at rtol 1e-5 / atol
1e-4 (the port adds t outer, s inner; the reference s outer, t inner: an
f32 reassociation apart). Within the port adc_free equals emulate with
``psum_quant=False`` bit for bit, and nibble planes equal dense ones.

binary: the sign planes, psum scales and metadata are byte-identical with
the reference's pack (its dense int4 compared as int8); the mean-|w|
scales match at rtol 1e-6 (XLA and PyTorch sum the rows in different
float32 orders); forwards match at 1e-4 and the psum scale calibration
at 1e-6. The registry mirrors ``tests/test_backends.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api import backends as jbk
from repro.backends import binary as jbin
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.nibble import pack_nibbles as j_pack_nibbles
from repro.kernels import ref as jref
from repro.kernels.cim_adc_free import (cim_conv_adc_free_pallas,
                                        cim_matmul_adc_free_pallas)
from repro_torch import api as tapi
from repro_torch.backends import binary as tbin
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cim_adc_free import (cim_conv_adc_free_cuda,
                                              cim_matmul_adc_free_cuda)
from test_torch_kernels import _matmul_case, _t

CPU = "cpu"
KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                act_bits=3, psum_bits=4, array_rows=36, array_cols=36,
                act_signed=False)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _layer(kind, tc, seed=0):
    """Port-made params of a linear (K=40, N=24) or 3x3 conv (9 -> 10)
    layer, calibrated on ``x``, as numpy."""
    rng = np.random.RandomState(seed)
    g = torch.Generator().manual_seed(seed)
    if kind == "linear":
        x = np.maximum(rng.randn(5, 40), 0).astype(np.float32)
        p = tapi.init_linear(g, 40, 24, tc, device=CPU)
        p = tapi.calibrate_linear(torch.from_numpy(x), p, tc)
    else:
        x = np.maximum(rng.randn(2, 8, 8, 9), 0).astype(np.float32)
        p = tapi.init_conv(g, 3, 3, 9, 10, tc, device=CPU)
        p = tapi.calibrate_conv(torch.from_numpy(x), p, tc)
    return to_numpy_tree(p), x


# -- registry ---------------------------------------------------------------

def test_registry_mirrors_reference():
    assert {"adc_free", "binary"} <= set(tapi.registered_backends())
    assert set(tapi.registered_backends()) <= set(jbk.registered_backends())
    for name in ("adc_free", "binary"):
        assert tapi.get_backend(name).packed
    assert tapi.get_backend("binary").plane_bits == (1, 1)
    assert tapi.get_backend("binary").pack_linear is not None
    assert tapi.get_backend("adc_free").pack_linear is None
    jc, tc = _cfgs()
    for mode in ("off", "emulate", "deploy", "ref", "adc_free", "binary"):
        jm, tm = jc.replace(mode=mode), tc.replace(mode=mode)
        assert tapi.is_packed(tm) == jbk.is_packed(jm)
        assert tapi.has_own_pack(tm) == jbk.has_own_pack(jm)
        assert tapi.plane_bits(tm) == jbk.plane_bits(jm)
        assert (tapi.plane_tiling(tm, 100, 24).n_split
                == jbk.plane_tiling(jm, 100, 24).n_split)
        tt, tcpa = tapi.conv_plane_tiling(tm, 3, 3, 9, 10)
        jt, jcpa = jbk.conv_plane_tiling(jm, 3, 3, 9, 10)
        assert (tt.n_split, tt.k_tiles, tcpa) == (jt.n_split, jt.k_tiles,
                                                  jcpa)
    assert not tapi.is_packed(tc.replace(enabled=False, mode="deploy"))


# -- adc_free kernels -------------------------------------------------------

@pytest.mark.parametrize("variant,unsigned", [
    ("dense", False), ("occ", True), ("nibble+occ", False),
    ("float", False), ("float+occ", True)])
def test_adc_free_matmul_matches_pallas(variant, unsigned):
    a, d, packed, _, deq, occ = _matmul_case(7, unsigned=unsigned)
    digits = packed if "nibble" in variant else d
    if "float" in variant:               # planes carrying cell variation
        digits = (d * np.exp(0.3 * np.random.RandomState(1).randn(*d.shape))
                  ).astype(np.float32)
    sparse = "occ" in variant
    want = np.asarray(cim_matmul_adc_free_pallas(
        jnp.asarray(a), jnp.asarray(digits), jnp.asarray(deq), None, None,
        jnp.asarray(occ) if sparse else None, interpret=True))
    logical = d if "nibble" in variant else digits
    oracle = np.asarray(jref.cim_matmul_adc_free_ref(
        jnp.asarray(a), jnp.asarray(logical), jnp.asarray(deq)))
    before = cim_matmul_adc_free_cuda.launches
    got = cim_matmul_adc_free_cuda(_t(a), _t(digits), _t(deq),
                                   _t(occ) if sparse else None)
    assert cim_matmul_adc_free_cuda.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **KERNEL_TOL)
    plain = ref.cim_matmul_adc_free_ref(_t(a), _t(logical), _t(deq))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    if "float" not in variant:
        # integer planes: round() is the identity, so adc_free is the ADC
        # kernel's arithmetic with the ADC off
        no_adc = ref.cim_matmul_ref(_t(a), _t(d), torch.ones_like(_t(deq)),
                                    _t(deq), psum_bits=4, psum_quant=False)
        np.testing.assert_array_equal(no_adc.numpy(), got.numpy())


@pytest.mark.parametrize("kh,stride,padding,variant", [
    (3, 1, "SAME", "occ"), (3, 2, "VALID", "nibble+occ"),
    (1, 2, "SAME", "nibble"), (3, 1, "SAME", "float")])
def test_adc_free_conv_matches_pallas(kh, stride, padding, variant):
    rng = np.random.RandomState(kh * 10 + stride)
    cpa, kt, s, c_in, c_out = 4, 2, 3, 7, 10
    a = rng.randint(0, 8, size=(2, 7, 6, c_in)).astype(np.int8)
    d6 = rng.randint(-1, 2, size=(s, kt, kh, kh, cpa, c_out)).astype(np.int8)
    d6[:, 1, :, :, cpa - 1] = 0                  # padded channel slot
    d6[..., 2:4] = 0                             # dead output channels
    occ = (d6 != 0).any(axis=(2, 3, 4)).astype(np.uint8)
    rows = kh * kh * cpa
    logical = d6.reshape(s, kt, rows, c_out)
    dig = logical
    if "nibble" in variant:
        dig = np.asarray(jax.jit(j_pack_nibbles)(d6)).reshape(
            s, kt, rows // 2, c_out)
    if variant == "float":
        logical = dig = (logical * np.exp(0.3 * rng.randn(*logical.shape))
                         ).astype(np.float32)
    deq = (rng.randn(s, kt, c_out) * 0.1).astype(np.float32)
    sparse = "occ" in variant
    geo = dict(kh=kh, kw=kh, stride=stride, padding=padding, c_per_array=cpa)
    want = np.asarray(cim_conv_adc_free_pallas(
        jnp.asarray(a), jnp.asarray(dig), jnp.asarray(deq), None, None,
        jnp.asarray(occ) if sparse else None, interpret=True, **geo))
    got = cim_conv_adc_free_cuda(_t(a), _t(dig), _t(deq),
                                 _t(occ) if sparse else None, **geo)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    plain = ref.cim_conv_adc_free_ref(_t(a), _t(logical), _t(deq), **geo)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    # the dispatch takes the same path, dense or sparse
    via_ops = ops.cim_conv(_t(a), _t(dig), None, _t(deq), psum_bits=4,
                           adc_free=True, **geo)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


# -- adc_free layers --------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_adc_free_layers_match_reference_and_emulate(kind):
    jc, tc = _cfgs(pack_dtype="int4")
    p_np, x = _layer(kind, tc)
    jfwd = japi.linear if kind == "linear" else japi.conv2d
    tfwd = tapi.linear if kind == "linear" else tapi.conv2d
    jpack = japi.pack_linear if kind == "linear" else japi.pack_conv
    tpack = tapi.pack_linear if kind == "linear" else tapi.pack_conv

    @jax.jit
    def jax_side(p, x_):
        return jfwd(x_, jpack(p, jc), jc.replace(mode="adc_free"),
                    compute_dtype=jnp.float32)

    want = np.asarray(jax_side(p_np, x))
    tp = from_numpy_tree(p_np, CPU)
    xt = torch.from_numpy(x)
    f32 = dict(compute_dtype=torch.float32)
    got = {dt: tfwd(xt, tpack(tp, tc.replace(pack_dtype=dt)),
                    tc.replace(mode="adc_free", pack_dtype=dt), **f32)
           for dt in ("int8", "int4")}
    np.testing.assert_allclose(got["int4"].numpy(), want, **LAYER_TOL)
    # nibble == dense; adc_free == emulate(psum_quant=False), bit for bit
    assert torch.equal(got["int4"], got["int8"])
    emulate = tfwd(xt, tp, tc.replace(psum_quant=False), **f32)
    assert torch.equal(got["int8"], emulate)
    # the ADC-free style ignores the ADC knobs it carries
    assert torch.equal(tfwd(xt, tpack(tp, tc),
                            tc.replace(mode="adc_free", psum_bits=2), **f32),
                       got["int8"])


# -- binary -----------------------------------------------------------------

@pytest.mark.parametrize("kind,pack_dtype", [("linear", "int8"),
                                             ("linear", "int4"),
                                             ("conv", "int8"),
                                             ("conv", "int4")])
def test_binary_pack_byte_identical(kind, pack_dtype):
    jc, tc = _cfgs(pack_dtype=pack_dtype, mode="binary")
    p_np, _ = _layer(kind, tc.replace(mode="emulate"))
    jpack = japi.pack_linear if kind == "linear" else japi.pack_conv
    tpack = tapi.pack_linear if kind == "linear" else tapi.pack_conv
    want = jax.tree.map(np.asarray, jax.jit(lambda p: jpack(p, jc))(p_np))
    got = to_numpy_tree(tpack(from_numpy_tree(p_np, CPU), tc))
    assert set(got) == set(want)
    for key, w in want.items():
        if w.dtype.name == "int4":
            w = w.astype(np.int8)           # the port's dense int4 storage
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        if key == "s_w":
            np.testing.assert_allclose(got[key], w, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert got["w_digits"].shape[0] == 1


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_binary_forward_matches_reference(kind):
    jc, tc = _cfgs(mode="binary")
    p_np, x = _layer(kind, tc.replace(mode="emulate"), seed=1)
    jfwd = japi.linear if kind == "linear" else japi.conv2d
    tfwd = tapi.linear if kind == "linear" else tapi.conv2d
    jpack = japi.pack_linear if kind == "linear" else japi.pack_conv
    key = jax.random.PRNGKey(5)

    @jax.jit
    def jax_side(p, x_):
        pk = jpack(p, jc)
        kw = dict(compute_dtype=jnp.float32)
        return (pk, jax.random.normal(key, pk["w_digits"].shape),
                jfwd(x_, pk, jc, **kw),
                jfwd(x_, pk, jc, variation_key=key, variation_std=0.3, **kw))

    j_packed, theta, want, want_var = jax.tree.map(np.asarray,
                                                   jax_side(p_np, x))
    # planes packed by the JAX package serve on the port as they are
    packed = from_numpy_tree(j_packed, CPU)
    xt = torch.from_numpy(x)
    got = tfwd(xt, packed, tc, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    got_var = tfwd(xt, packed, tc, variation=theta, variation_std=0.3,
                   compute_dtype=torch.float32)
    np.testing.assert_allclose(got_var.numpy(), want_var, **LAYER_TOL)
    assert not torch.equal(got_var, got)
    # the port's own pack serves the same
    own = tapi.pack_linear if kind == "linear" else tapi.pack_conv
    np.testing.assert_allclose(
        tfwd(xt, own(from_numpy_tree(p_np, CPU), tc), tc,
             compute_dtype=torch.float32).numpy(), want, **LAYER_TOL)


def test_binary_calibrate_psum_scale_matches_reference():
    jc, tc = _cfgs(mode="binary", psum_bits=5)
    p_np, x = _layer("linear", tc.replace(mode="emulate"), seed=2)
    j_packed = jax.tree.map(np.asarray,
                            jax.jit(lambda p: japi.pack_linear(p, jc))(p_np))
    want = np.asarray(jax.jit(lambda pk, x_: jbin.binary_calibrate_psum_scale(
        pk, jc, x_)["s_p"])(j_packed, x))
    got = tbin.binary_calibrate_psum_scale(from_numpy_tree(j_packed, CPU), tc,
                                           torch.from_numpy(x))
    assert got["s_p"].shape == want.shape == (1, 2, 24)
    np.testing.assert_allclose(got["s_p"].numpy(), want, rtol=1e-6)
    assert torch.equal(got["w_digits"], torch.from_numpy(
        j_packed["w_digits"].astype(np.int8)))
