"""The port's CIM conv layer against the JAX package's.

Params are made by the JAX package and carried across as numpy
(``repro_torch.interop``). Packed 6-D planes and occupancy maps must be
byte-identical with ``repro.api.pack_conv``; emulate and deploy outputs
match the reference at 1e-4 (the tolerance of
``tests/test_cim_conv_deploy.py``), and within the port deploy is
bit-identical with emulate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro_torch import api as tapi
from repro_torch.core.cim_conv import conv_deploy_operands
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.interop import from_numpy_tree, to_numpy_tree

CPU = "cpu"


def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                act_bits=3, psum_bits=4, array_rows=64, array_cols=64,
                act_signed=False)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _setup(tc, *, kh=3, c_in=19, c_out=10, b=2, hw=8, stride=1,
           padding="SAME", seed=0):
    """Params of one conv layer, made by the port (init from a seed, then
    calibrated on ``x``) and handed to both packages as numpy. The port's
    init and calibration are themselves held against the reference below."""
    x = np.maximum(np.random.RandomState(seed).randn(b, hw, hw, c_in),
                   0).astype(np.float32)
    p = tapi.init_conv(torch.Generator().manual_seed(seed), kh, kh, c_in,
                       c_out, tc, device=CPU)
    p = tapi.calibrate_conv(torch.from_numpy(x), p, tc, stride=stride,
                            padding=padding)
    return to_numpy_tree(p), x


@pytest.mark.parametrize("pack_dtype,rows,kh", [
    ("int8", 64, 3), ("int4", 64, 3), ("int4", 128, 3), ("int4", 64, 1),
    ("int8", 128, 1)])
def test_pack_conv_byte_exact(pack_dtype, rows, kh):
    jc, tc = _cfgs(pack_dtype=pack_dtype, array_rows=rows, array_cols=rows)
    p_np, _ = _setup(tc, kh=kh)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda p: japi.pack_conv(p, jc))(p_np))
    got = to_numpy_tree(tapi.pack_conv(from_numpy_tree(p_np, CPU), tc))
    assert set(got) == set(ref)
    for key in ref:
        r = ref[key]
        if r.dtype.name == "int4":
            r = r.astype(np.int8)          # the port's dense int4 storage
        assert got[key].dtype == r.dtype and got[key].shape == r.shape, key
        np.testing.assert_array_equal(got[key], r, err_msg=key)


@pytest.mark.parametrize("stride,padding,gran,psum_bits,pack_dtype", [
    (1, "SAME", "column", 4, "int4"),
    (2, "VALID", "column", 4, "int8"),
    (2, "SAME", "array", 1, "int4"),
    (1, "VALID", "layer", 8, "int8"),
])
def test_conv_emulate_deploy_match_reference(stride, padding, gran, psum_bits,
                                             pack_dtype):
    jc, tc = _cfgs(weight_granularity=gran, psum_granularity=gran,
                   psum_bits=psum_bits, pack_dtype=pack_dtype, array_cols=16)
    p_np, x = _setup(tc, stride=stride, padding=padding)
    geo = dict(stride=stride, padding=padding)
    # the reference's deploy kernel at psum_bits > 1, its plain oracle at the
    # sign ADC (its sparse kernel body drifts there; ROADMAP faults)
    jd = jc.replace(mode="deploy", use_kernel=psum_bits > 1)

    @jax.jit
    def jax_side(p, x_):
        return (japi.conv2d(x_, p, jc, compute_dtype=jnp.float32, **geo),
                japi.conv2d(x_, japi.pack_conv(p, jc), jd,
                            compute_dtype=jnp.float32, **geo))

    y_je, y_jd = jax_side(p_np, x)
    tp = from_numpy_tree(p_np, CPU)
    xt = torch.from_numpy(x)
    y_te = tapi.conv2d(xt, tp, tc, compute_dtype=torch.float32, **geo)
    np.testing.assert_allclose(y_te.numpy(), y_je, rtol=1e-4, atol=1e-4)
    tpk = tapi.pack_conv(tp, tc)
    y_td = tapi.conv2d(xt, tpk, tc.replace(mode="deploy"),
                       compute_dtype=torch.float32, **geo)
    np.testing.assert_allclose(y_td.numpy(), y_jd, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(y_td.numpy(), y_te.numpy())
    y_tr = tapi.conv2d(xt, tpk, tc.replace(mode="ref"),
                       compute_dtype=torch.float32, **geo)
    np.testing.assert_array_equal(y_tr.numpy(), y_td.numpy())


def test_conv_deploy_from_reference_pack():
    """Planes packed by the JAX package serve on the port unchanged, with
    a per-column recalibration gain (``deq_scale``) riding along."""
    jc, tc = _cfgs(pack_dtype="int4")
    p_np, x = _setup(tc, kh=3, c_in=16, c_out=12)
    gain = (1 + 0.1 * np.random.RandomState(4).randn(3, 3, 12)).astype(
        np.float32)
    jd = jc.replace(mode="deploy")

    @jax.jit
    def jax_side(p, x_, g):
        packed = dict(japi.pack_conv(p, jc), deq_scale=g)
        return packed, japi.conv2d(x_, packed, jd, compute_dtype=jnp.float32)

    packed, y_jd = jax.tree.map(np.asarray, jax_side(p_np, x, gain))
    y_td = tapi.conv2d(torch.from_numpy(x), from_numpy_tree(packed, CPU),
                       tc.replace(mode="deploy"), compute_dtype=torch.float32)
    np.testing.assert_allclose(y_td.numpy(), y_jd, rtol=1e-4, atol=1e-4)


def test_off_backend_matches_reference():
    jc, tc = _cfgs(enabled=False)
    p = jax.tree.map(np.asarray, japi.init_conv(jax.random.PRNGKey(3), 3, 3, 5,
                                                 6, jc))
    x = np.random.RandomState(3).randn(2, 7, 7, 5).astype(np.float32)
    for stride, padding in ((1, "SAME"), (2, "VALID"), (2, "SAME")):
        want = np.asarray(japi.conv2d(jnp.asarray(x), jax.tree.map(
            jnp.asarray, p), jc, stride=stride, padding=padding,
            compute_dtype=jnp.float32))
        got = tapi.conv2d(torch.from_numpy(x), from_numpy_tree(p, CPU), tc,
                          stride=stride, padding=padding,
                          compute_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,gran", [(1, "column"), (2, "array"),
                                         (1, "layer")])
def test_calibrate_conv_matches_reference(stride, gran):
    jc, tc = _cfgs(weight_granularity=gran, psum_granularity=gran,
                   array_cols=16)
    p = jax.tree.map(np.asarray, japi.init_conv(jax.random.PRNGKey(1), 3, 3,
                                                 19, 10, jc))
    x = np.maximum(np.random.RandomState(1).randn(2, 8, 8, 19), 0).astype(
        np.float32)
    want = jax.jit(lambda x_, p_: japi.calibrate_conv(
        x_, p_, jc, stride=stride))(x, p)
    got = tapi.calibrate_conv(torch.from_numpy(x), from_numpy_tree(p, CPU), tc,
                              stride=stride)
    for key in ("s_a", "s_p", "s_w"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, err_msg=key)


def test_conv_init_shapes_and_scales_follow_reference():
    jc, tc = _cfgs(weight_granularity="array", array_cols=16)
    tp = tapi.init_conv(torch.Generator().manual_seed(0), 3, 3, 19, 10, tc,
                        device=CPU)
    jp = japi.init_conv(jax.random.PRNGKey(0), 3, 3, 19, 10, jc)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    np.testing.assert_allclose(tp["s_p"].numpy(), np.asarray(jp["s_p"]),
                               rtol=1e-6)


def test_deploy_operands_reject_planes_of_another_geometry():
    _, tc = _cfgs()
    p_np, x = _setup(tc)
    packed = tapi.pack_conv(from_numpy_tree(p_np, CPU), tc)
    op = conv_deploy_operands(torch.from_numpy(x), packed, tc)
    assert op["a_int"].dtype == torch.int8
    assert (op["kh"], op["kw"], op["c_per_array"]) == (3, 3, 7)
    with pytest.raises(ValueError, match="different geometry"):
        conv_deploy_operands(torch.zeros((1, 8, 8, 30)), packed, tc)
    # the operands stay clean under variation: the planes are perturbed at
    # dispatch (kernels/ops.cim_conv)
    noisy = conv_deploy_operands(torch.from_numpy(x), packed,
                                 tc.replace(variation_std=0.1))
    assert torch.equal(noisy["digits"], op["digits"])
    assert noisy["digits"].dtype == packed["w_digits"].dtype
