"""The port's cell-variation model against the JAX package's, on the CPU.

Randomness does not cross frameworks, so the noise field theta is drawn
by JAX (``jax.random.normal`` over the logical packed shape, which is
what the reference draws from its key) and handed to the port as numpy.
Perturbed planes then match the reference at rtol 1e-6 (the two
libraries' ``exp`` may differ by an ulp); layer outputs under variation
match at 1e-4, the reference's deploy-vs-emulate tolerance. Within the
port, deploy equals emulate bit for bit under variation, because both
run the noisy MACs in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import variation as jvar
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.nibble import unpack_nibbles as j_unpack_nibbles
from repro_torch import api as tapi
from repro_torch.core import variation as tvar
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.core.nibble import unpack_nibbles
from repro_torch.interop import from_numpy_tree, to_numpy_tree

CPU = "cpu"
SIGMA = 0.3


def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                act_bits=3, psum_bits=4, array_rows=32, array_cols=32,
                act_signed=False)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _linear(tc, seed=0, k=40, n=24, b=5):
    x = np.maximum(np.random.RandomState(seed).randn(b, k), 0).astype(
        np.float32)
    p = tapi.init_linear(torch.Generator().manual_seed(seed), k, n, tc,
                         device=CPU)
    p = tapi.calibrate_linear(torch.from_numpy(x), p, tc)
    return to_numpy_tree(p), x


def _conv(tc, seed=0, kh=3, c_in=9, c_out=10, stride=1):
    x = np.maximum(np.random.RandomState(seed).randn(2, 8, 8, c_in),
                   0).astype(np.float32)
    p = tapi.init_conv(torch.Generator().manual_seed(seed), kh, kh, c_in,
                       c_out, tc, device=CPU)
    p = tapi.calibrate_conv(torch.from_numpy(x), p, tc, stride=stride)
    return to_numpy_tree(p), x


def _logical_shape(packed):
    d = packed["w_digits"]
    shape = list(d.shape)
    if d.dtype == jnp.uint8:
        shape[-2] *= 2
    return tuple(shape)


def _theta(key, shape):
    """The reference's field for ``key`` over ``shape`` (inside a jit: an
    eager draw compiles a generator per shape)."""
    return jax.random.normal(key, shape, jnp.float32)


@pytest.mark.parametrize("kind,pack_dtype", [("linear", "int8"),
                                             ("conv", "int4")])
def test_perturbed_planes_match_reference(kind, pack_dtype):
    # 36-row arrays: the 3x3 conv holds c_per_array = 4 (even: nibbles)
    jc, tc = _cfgs(pack_dtype=pack_dtype, array_rows=36, array_cols=36)
    p_np, _ = (_linear if kind == "linear" else _conv)(tc)
    jpack = japi.pack_linear if kind == "linear" else japi.pack_conv
    key = jax.random.PRNGKey(1)

    @jax.jit
    def jax_side(p):
        packed = jpack(p, jc)
        d = packed["w_digits"]
        logical = j_unpack_nibbles(d) if d.dtype == jnp.uint8 else d
        return (packed, _theta(key, logical.shape),
                jvar.perturb_packed(packed, key, SIGMA)["w_digits"],
                jvar.perturb_digits(logical, key, SIGMA),
                jvar.variation_noise(key, logical.shape, SIGMA))

    j_packed, theta, want, want_d, want_noise = jax.tree.map(
        np.asarray, jax_side(p_np))
    if pack_dtype == "int4":
        assert j_packed["w_digits"].dtype == np.uint8
    t_packed = from_numpy_tree(j_packed, CPU)
    got = tvar.perturb_packed(t_packed, theta, SIGMA)
    assert got["w_digits"].dtype == torch.float32
    np.testing.assert_allclose(got["w_digits"].numpy(), want, rtol=1e-6,
                               atol=0)
    assert torch.equal(got["w_occ"], t_packed["w_occ"])
    # perturb_digits on the logical planes, as the reference's
    logical = t_packed["w_digits"]
    if logical.dtype == torch.uint8:
        logical = unpack_nibbles(logical)
    np.testing.assert_allclose(
        tvar.perturb_digits(logical, theta, SIGMA).numpy(), want_d,
        rtol=1e-6, atol=0)
    # the factor is exp(sigma * theta) in float32
    np.testing.assert_allclose(
        tvar.variation_noise(theta, theta.shape, SIGMA).numpy(), want_noise,
        rtol=1e-6)


@pytest.mark.parametrize("pack_dtype,psum_bits", [("int8", 4), ("int4", 4),
                                                  ("int8", 1)])
def test_linear_under_variation_matches_reference(pack_dtype, psum_bits):
    jc, tc = _cfgs(pack_dtype=pack_dtype, psum_bits=psum_bits)
    p_np, x = _linear(tc, seed=psum_bits)
    key = jax.random.PRNGKey(2)

    @jax.jit
    def jax_side(p, x_):
        pk = japi.pack_linear(p, jc)
        kw = dict(variation_key=key, variation_std=SIGMA,
                  compute_dtype=jnp.float32)
        return (_theta(key, _logical_shape(pk)), japi.linear(x_, p, jc, **kw),
                japi.linear(x_, pk, jc.replace(mode="deploy"), **kw))

    theta, y_je, y_jd = (np.asarray(v) for v in jax_side(p_np, x))
    tp = from_numpy_tree(p_np, CPU)
    t_packed = tapi.pack_linear(tp, tc)
    kw = dict(variation=theta, variation_std=SIGMA,
              compute_dtype=torch.float32)
    y_te = tapi.linear(torch.from_numpy(x), tp, tc, **kw)
    y_td = tapi.linear(torch.from_numpy(x), t_packed,
                       tc.replace(mode="deploy"), **kw)
    np.testing.assert_allclose(y_te.numpy(), y_je, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y_td.numpy(), y_jd, rtol=1e-4, atol=1e-4)
    assert torch.equal(y_td, y_te)
    clean = tapi.linear(torch.from_numpy(x), tp, tc,
                        compute_dtype=torch.float32)
    assert not torch.equal(clean, y_te)


@pytest.mark.parametrize("pack_dtype,kh,stride,padding", [
    ("int4", 3, 2, "SAME"), ("int8", 1, 1, "VALID")])
def test_conv_under_variation_matches_reference(pack_dtype, kh, stride,
                                                padding):
    # 36-row arrays: 3x3 holds 4 channels a tile (nibbles), 1x1 holds 36
    jc, tc = _cfgs(pack_dtype=pack_dtype, array_rows=36, array_cols=36)
    p_np, x = _conv(tc, kh=kh, stride=stride)
    key = jax.random.PRNGKey(3)

    # the reference's deploy arithmetic through its plain oracle ("ref"):
    # its Pallas kernel under variation is held against the port in the
    # linear test above
    @jax.jit
    def jax_side(p, x_):
        pk = japi.pack_conv(p, jc)
        kw = dict(stride=stride, padding=padding, variation_key=key,
                  variation_std=SIGMA, compute_dtype=jnp.float32)
        return (_theta(key, _logical_shape(pk)), japi.conv2d(x_, p, jc, **kw),
                japi.conv2d(x_, pk, jc.replace(mode="ref"), **kw))

    theta, y_je, y_jd = (np.asarray(v) for v in jax_side(p_np, x))
    tp = from_numpy_tree(p_np, CPU)
    t_packed = tapi.pack_conv(tp, tc)
    kw = dict(stride=stride, padding=padding, variation=theta,
              variation_std=SIGMA, compute_dtype=torch.float32)
    y_te = tapi.conv2d(torch.from_numpy(x), tp, tc, **kw)
    y_td = tapi.conv2d(torch.from_numpy(x), t_packed,
                       tc.replace(mode="deploy"), **kw)
    np.testing.assert_allclose(y_te.numpy(), y_je, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y_td.numpy(), y_jd, rtol=1e-4, atol=1e-4)
    assert torch.equal(y_td, y_te)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_zero_sigma_or_no_variation_is_clean(kind):
    _, tc = _cfgs(pack_dtype="int4", array_rows=36, array_cols=36)
    p_np, x = (_linear if kind == "linear" else _conv)(tc)
    tp = from_numpy_tree(p_np, CPU)
    pack = tapi.pack_linear if kind == "linear" else tapi.pack_conv
    fwd = tapi.linear if kind == "linear" else tapi.conv2d
    packed = pack(tp, tc)
    xt = torch.from_numpy(x)
    sampler = tvar.Sampler(5)
    for params, cfg in ((tp, tc), (packed, tc.replace(mode="deploy")),
                        (packed, tc.replace(mode="adc_free"))):
        clean = fwd(xt, params, cfg, compute_dtype=torch.float32)
        for kw in (dict(variation=sampler, variation_std=0.0),
                   dict(variation=sampler),            # no sigma anywhere
                   dict(variation=None, variation_std=SIGMA),
                   dict(variation=sampler, variation_std=-0.1)):
            got = fwd(xt, params, cfg, compute_dtype=torch.float32, **kw)
            assert torch.equal(got, clean), (cfg.mode, kw)
        noisy = fwd(xt, params, cfg.replace(variation_std=SIGMA),
                    variation=sampler, compute_dtype=torch.float32)
        assert not torch.equal(noisy, clean)
    # a pack without a sigma bakes nothing
    assert torch.equal(pack(tp, tc, variation=sampler)["w_digits"],
                       packed["w_digits"])


def test_sampler_is_deterministic_and_shares_theta_across_sigma():
    shape = (3, 2, 36, 10)
    s = tvar.Sampler(11, sample=2)
    assert torch.equal(s.theta(shape), tvar.Sampler(11, sample=2).theta(shape))
    assert s.at(3) == tvar.Sampler(11, sample=3)
    for other in (s.at(3), tvar.Sampler(12, sample=2), s.for_layer("conv1")):
        assert not torch.equal(other.theta(shape), s.theta(shape))
    theta = s.theta(shape)
    assert theta.dtype == torch.float32
    assert abs(float(theta.mean())) < 0.1 and abs(float(theta.std()) - 1) < 0.1
    # common random numbers: sample i draws the same field at every sigma
    d = torch.randint(-1, 2, shape, dtype=torch.int8)
    for sigma in (0.1, 0.2, 0.4):
        np.testing.assert_allclose(
            tvar.perturb_digits(d, s, sigma).numpy(),
            (d.float() * torch.exp(sigma * theta)).numpy(), rtol=1e-6)
    # perturb_packed's `sample` picks the sampler's Monte-Carlo sample
    packed = {"w_digits": d, "s_a": torch.ones(1)}
    assert torch.equal(
        tvar.perturb_packed(packed, tvar.Sampler(11), 0.2, sample=2)[
            "w_digits"],
        tvar.perturb_digits(d, s, 0.2))
    with pytest.raises(TypeError):
        tvar.perturb_packed(packed, theta, 0.2, sample=1)
    # sigma: the explicit variation_std, else cfg's
    assert tvar.resolve_sigma(0.3, 0.1) == 0.3
    assert tvar.resolve_sigma(0.0, 0.1) == 0.0
    assert tvar.resolve_sigma(None, 0.1) == 0.1
    with pytest.raises(ValueError, match="does not cover"):
        tvar.variation_noise(theta, (3, 2, 36, 11), 0.2)


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_baked_realization_matches_reference(kind):
    jc, tc = _cfgs(pack_dtype="int4", array_rows=36, array_cols=36)
    p_np, x = (_linear if kind == "linear" else _conv)(tc)
    jpack = japi.pack_linear if kind == "linear" else japi.pack_conv
    tpack = tapi.pack_linear if kind == "linear" else tapi.pack_conv
    fwd = tapi.linear if kind == "linear" else tapi.conv2d
    key = jax.random.PRNGKey(4)

    @jax.jit
    def jax_side(p):
        return (_theta(key, _logical_shape(jpack(p, jc))),
                jpack(p, jc, variation_key=key,
                      variation_std=SIGMA)["w_digits"])

    theta, want = (np.asarray(v) for v in jax_side(p_np))
    tp = from_numpy_tree(p_np, CPU)
    baked = tpack(tp, tc, variation=theta, variation_std=SIGMA)
    np.testing.assert_allclose(baked["w_digits"].numpy(), want, rtol=1e-6)
    # serving the baked planes equals perturbing the clean ones at dispatch
    dc = tc.replace(mode="deploy")
    xt = torch.from_numpy(x)
    assert torch.equal(
        fwd(xt, baked, dc, compute_dtype=torch.float32),
        fwd(xt, tpack(tp, tc), dc, variation=theta, variation_std=SIGMA,
            compute_dtype=torch.float32))
