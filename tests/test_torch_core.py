"""Core numerics of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and go through both packages on
the CPU. Integer stages (codes, digits, nibble bytes, occupancy, act
codes, packed planes) must match exactly; float outputs of a whole layer
match at the reference's kernel-vs-oracle tolerance (rtol 1e-5, atol
1e-4) because the two frameworks sum in different orders.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import bitsplit as jbits
from repro.core import granularity as jgran
from repro.core import nibble as jnib
from repro.core import quantizer as jq
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.cim_linear import deploy_act_codes as j_deploy_act_codes
from repro.core.cim_linear import weight_scales_from as j_weight_scales_from
from repro_torch import api as tapi
from repro_torch import resolve_device
from repro_torch.core import bitsplit as tbits
from repro_torch.core import granularity as tgran
from repro_torch.core import nibble as tnib
from repro_torch.core import quantizer as tq
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.core.cim_linear import deploy_act_codes as t_deploy_act_codes
from repro_torch.core.cim_linear import weight_scales_from as t_weight_scales_from
from repro_torch.interop import from_numpy_tree, to_numpy_tree

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                act_bits=3, psum_bits=4, array_rows=32, array_cols=32,
                act_signed=False)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


@pytest.mark.parametrize("bits,signed", [(1, True), (2, True), (3, False),
                                         (4, True), (8, False), (8, True)])
def test_lsq_fake_quant_and_integer_exact(bits, signed):
    rng = np.random.RandomState(bits)
    x = (rng.randn(64, 12) * 3).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 0.0]            # ties round half to even
    s = np.abs(rng.randn(1, 12)).astype(np.float32) + 0.1
    assert tq.qrange(bits, signed) == jq.qrange(bits, signed)
    for jf, tf in ((jq.lsq_fake_quant, tq.lsq_fake_quant),
                   (jq.lsq_integer, tq.lsq_integer)):
        ref = np.asarray(jf(jnp.asarray(x), jnp.asarray(s), bits,
                            signed=signed))
        got = tf(_t(x), _t(s), bits, signed=signed).numpy()
        np.testing.assert_array_equal(got, ref)


def test_init_scale_from_matches():
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    ref = np.asarray(jq.init_scale_from(jnp.asarray(x), 4, 0, (1, 8)))
    got = tq.init_scale_from(_t(x), 4, 0, (1, 8)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    ref = np.asarray(jq.init_scale_from(jnp.asarray(x), 4, (0, 1), (1, 1)))
    got = tq.init_scale_from(_t(x), 4, (0, 1), (1, 1)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("k,n,rows,cols,wb,cb", [
    (100, 70, 32, 32, 4, 2), (128, 16, 128, 128, 3, 1), (33, 5, 16, 8, 8, 3)])
def test_tiling_and_broadcast_match(k, n, rows, cols, wb, cb):
    jt = jgran.ArrayTiling(k, n, rows, cols, wb, cb)
    tt = tgran.ArrayTiling(k, n, rows, cols, wb, cb)
    for prop in ("n_split", "k_tiles", "k_padded", "oc_per_array", "n_tiles",
                 "n_arrays"):
        assert getattr(tt, prop) == getattr(jt, prop), prop
    rng = np.random.RandomState(k)
    for g in jgran.Granularity:
        tg = tgran.Granularity(g.value)
        assert tt.weight_scale_shape(tg) == jt.weight_scale_shape(g)
        assert tt.psum_scale_shape(tg) == jt.psum_scale_shape(g)
        assert tt.weight_group_size(tg) == jt.weight_group_size(g)
        for g2 in jgran.Granularity:
            assert (tt.dequant_muls(tg, tgran.Granularity(g2.value))
                    == jt.dequant_muls(g, g2))
        sw = rng.rand(*jt.weight_scale_shape(g)).astype(np.float32)
        sp = rng.rand(*jt.psum_scale_shape(g)).astype(np.float32)
        np.testing.assert_array_equal(
            tt.broadcast_weight_scale(_t(sw)).numpy(),
            np.asarray(jt.broadcast_weight_scale(jnp.asarray(sw))))
        np.testing.assert_array_equal(
            tt.broadcast_psum_scale(_t(sp)).numpy(),
            np.asarray(jt.broadcast_psum_scale(jnp.asarray(sp))))


@pytest.mark.parametrize("kh,c_in,c_out,rows", [(3, 19, 10, 64), (1, 16, 32, 128),
                                                (3, 64, 64, 128), (5, 3, 8, 16)])
def test_conv_tiling_matches(kh, c_in, c_out, rows):
    jt, jc = jgran.conv_tiling(kh, kh, c_in, c_out, rows, rows, 3, 1)
    tt, tc = tgran.conv_tiling(kh, kh, c_in, c_out, rows, rows, 3, 1)
    assert tc == jc and dataclasses_equal(tt, jt)


def dataclasses_equal(a, b):
    return all(getattr(a, f) == getattr(b, f)
               for f in ("k", "n", "array_rows", "array_cols", "weight_bits",
                         "cell_bits"))


@pytest.mark.parametrize("wb,cb", [(1, 1), (3, 1), (4, 2), (8, 3), (7, 7)])
def test_split_digits_place_values_recombine_exact(wb, cb):
    lim = 2 ** (wb - 1) - 1 if wb > 1 else 1
    rng = np.random.RandomState(wb * 10 + cb)
    w = rng.randint(-lim, lim + 1, size=(3, 20, 9)).astype(np.float32)
    if wb == 1:
        w = np.where(w >= 0, 1.0, -1.0).astype(np.float32)
    ref = np.asarray(jbits.split_digits(jnp.asarray(w), wb, cb))
    got = tbits.split_digits(_t(w), wb, cb).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tbits.place_values(wb, cb).numpy(),
                                  np.asarray(jbits.place_values(wb, cb)))
    np.testing.assert_array_equal(tbits.recombine(_t(ref), wb, cb).numpy(), w)


@pytest.mark.parametrize("groups", [1, 3, 9])
def test_nibble_pack_unpack_bytes_exact(groups):
    rng = np.random.RandomState(groups)
    d = rng.randint(-8, 8, size=(2, 3, groups * 8, 11)).astype(np.int8)
    d[0, 0, 0, :4] = [-8, 7, 0, -1]
    if groups == 1:
        ref = np.asarray(jnib.pack_nibbles(jnp.asarray(d)))
        got = tnib.pack_nibbles(_t(d))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), ref)
    # a flattened conv view: each of the groups packs on its own
    per = d.reshape(2, 3, groups, 8, 11)
    packed = np.asarray(jnib.pack_nibbles(jnp.asarray(per))).reshape(
        2, 3, groups * 4, 11)
    ref = np.asarray(jnib.unpack_nibbles(jnp.asarray(packed), groups=groups))
    got = tnib.unpack_nibbles(_t(packed), groups=groups)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), d)


def test_nibble_rules_and_occupancy_match():
    for rows in (8, 9, 126, 128):
        assert (tnib.can_pack_nibbles(rows, tnib.INT4)
                == jnib.can_pack_nibbles(rows, jnp.int4))
        assert not tnib.can_pack_nibbles(rows, torch.int8)
        t_rows, t_dtype = tnib.stored_rows(rows, tnib.INT4)
        j_rows, j_dtype = jnib.stored_rows(rows, jnp.int4)
        assert t_rows == j_rows
        assert t_dtype == (torch.uint8 if rows % 2 == 0 else torch.int8)
    with pytest.raises(ValueError):
        tnib.pack_nibbles(torch.zeros((2, 3, 5, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        tnib.unpack_nibbles(torch.zeros((2, 3, 5, 4), dtype=torch.uint8),
                            groups=2)
    rng = np.random.RandomState(3)
    d = rng.randint(-1, 2, size=(3, 2, 8, 10)).astype(np.int8)
    d[1, 0, :, :5] = 0
    d[2, 1] = 0
    np.testing.assert_array_equal(tnib.occupancy_map(_t(d)).numpy(),
                                  np.asarray(jnib.occupancy_map(jnp.asarray(d))))
    d6 = rng.randint(-1, 2, size=(3, 2, 3, 3, 4, 7)).astype(np.int8)
    d6[0, 1, :, :, :, 2] = 0
    np.testing.assert_array_equal(
        tnib.occupancy_map(_t(d6), conv=True).numpy(),
        np.asarray(jnib.occupancy_map(jnp.asarray(d6), conv=True)))


def test_cim_config_validation_matches_reference():
    for bad in (dict(mode="nope"), dict(pack_dtype="int2"),
                dict(weight_granularity="rows"), dict(psum_bits=0)):
        with pytest.raises(ValueError):
            JCIMConfig(**bad)
        with pytest.raises(ValueError):
            TCIMConfig(**bad)
    c = TCIMConfig(weight_granularity="array", psum_granularity="layer")
    assert c.weight_granularity is tgran.Granularity.ARRAY
    assert c.psum_granularity is tgran.Granularity.LAYER
    with pytest.raises(TypeError):
        c.replace(nope=1)
    assert TCIMConfig(pack_dtype="int4", cell_bits=3).store_dtype() == tnib.INT4
    assert TCIMConfig(pack_dtype="int4", cell_bits=4).store_dtype() == torch.int8
    assert TCIMConfig(pack_dtype="int8").store_dtype() == torch.int8
    assert set(tapi.registered_backends()) == {"off", "emulate", "deploy", "ref",
                                               "adc_free", "binary"}
    with pytest.raises(ValueError):
        tapi.register_backend(tapi.get_backend("deploy"))


@pytest.mark.parametrize("bits,signed,dtype", [(3, False, torch.int8),
                                               (8, True, torch.int8),
                                               (8, False, torch.uint8)])
def test_deploy_act_codes_exact(bits, signed, dtype):
    jc, tc = _cfgs(act_bits=bits, act_signed=signed)
    x = (np.random.RandomState(bits).randn(5, 40) * 40).astype(np.float32)
    s_a = np.asarray([0.37], np.float32)
    ref = np.asarray(j_deploy_act_codes(jnp.asarray(x), jnp.asarray(s_a), jc))
    got = t_deploy_act_codes(_t(x), _t(s_a), tc)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  ref.astype(np.int32))


@pytest.mark.parametrize("bits,signed", [(3, False), (8, True), (8, False)])
def test_emulate_act_codes_are_the_deploy_codes(bits, signed):
    """Emulate's codes are the deploy codes exactly (fake-quant / s_a can
    land an ulp off the integer), and the snap onto the grid is
    straight-through: the gradient is ``lsq_fake_quant``'s own."""
    from repro_torch.core.cim_linear import _quantize_act
    _, tc = _cfgs(act_bits=bits, act_signed=signed)
    x = _t((np.random.RandomState(bits).randn(50, 40) * 40).astype(np.float32))
    x.requires_grad_(True)
    s_a = _t(np.asarray([0.37], np.float32))
    a, _ = _quantize_act(x, {"s_a": s_a}, tc)
    codes = t_deploy_act_codes(x.detach(), s_a, tc).to(torch.float32)
    assert torch.equal(a.detach(), codes)
    (got,) = torch.autograd.grad(a.sum(), x)
    (want,) = torch.autograd.grad(
        (tq.lsq_fake_quant(x, s_a, bits, signed=signed) / s_a).sum(), x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("gran", ["column", "array", "layer"])
def test_weight_scales_from_matches(gran):
    jc, tc = _cfgs(weight_granularity=gran, array_cols=16)
    w = np.random.RandomState(1).randn(70, 23).astype(np.float32)
    ref = np.asarray(j_weight_scales_from(jnp.asarray(w), jc))
    got = t_weight_scales_from(_t(w), tc).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _linear_setup(tc, k=70, n=23, b=6, seed=0):
    """Params of one linear layer, made by the port (init from a seed, then
    calibrated on ``x``) and handed to both packages as numpy; the port's
    calibration is held against the reference below."""
    x = np.maximum(np.random.RandomState(seed).randn(b, k), 0).astype(np.float32)
    p = tapi.init_linear(torch.Generator().manual_seed(seed), k, n, tc,
                         device=CPU)
    p = tapi.calibrate_linear(torch.from_numpy(x), p, tc)
    return to_numpy_tree(p), x


@pytest.mark.parametrize("pack_dtype,rows", [("int8", 32), ("int4", 32),
                                             ("int4", 33)])
def test_pack_linear_byte_exact(pack_dtype, rows):
    jc, tc = _cfgs(pack_dtype=pack_dtype, array_rows=rows)
    p_np, _ = _linear_setup(tc)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda p: japi.pack_linear(p, jc))(p_np))
    got = to_numpy_tree(tapi.pack_linear(from_numpy_tree(p_np, CPU), tc))
    assert set(got) == set(ref)
    for key in ref:
        r = ref[key]
        if r.dtype.name == "int4":
            r = r.astype(np.int8)          # the port's dense int4 storage
        assert got[key].dtype == r.dtype, key
        np.testing.assert_array_equal(got[key], r, err_msg=key)
    nibble = pack_dtype == "int4" and rows % 2 == 0
    assert (got["w_digits"].dtype == np.uint8) == nibble


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
@pytest.mark.parametrize("psum_bits", [1, 4])
def test_linear_emulate_and_deploy_match_reference(pack_dtype, psum_bits):
    jc, tc = _cfgs(pack_dtype=pack_dtype, psum_bits=psum_bits)
    p_np, x = _linear_setup(tc)
    jd = jc.replace(mode="deploy", use_kernel=False)

    @jax.jit
    def jax_side(p, x_):
        return (japi.linear(x_, p, jc, compute_dtype=jnp.float32),
                japi.linear(x_, japi.pack_linear(p, jc), jd,
                            compute_dtype=jnp.float32))

    y_je, y_jd = jax_side(p_np, x)
    tp = from_numpy_tree(p_np, CPU)
    y_te = tapi.linear(_t(x), tp, tc, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(y_te, y_je, rtol=1e-5, atol=1e-4)
    # y_jd: the JAX deploy through its plain oracle (the reference's sign-
    # ADC sparse kernel is known to drift; see ROADMAP faults)
    tpk = tapi.pack_linear(tp, tc)
    y_td = tapi.linear(_t(x), tpk, tc.replace(mode="deploy"),
                       compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(y_td, y_jd, rtol=1e-5, atol=1e-4)
    # within the port, deploy is bit-identical with emulate
    np.testing.assert_array_equal(y_td, y_te)


def test_calibrate_linear_matches_reference():
    jc, tc = _cfgs()
    p = jax.tree.map(np.asarray, japi.init_linear(jax.random.PRNGKey(2), 70,
                                                  23, jc))
    x = np.maximum(np.random.RandomState(2).randn(6, 70), 0).astype(np.float32)
    ref = jax.jit(lambda x_, p_: japi.calibrate_linear(x_, p_, jc))(x, p)
    got = tapi.calibrate_linear(_t(x), from_numpy_tree(p, CPU), tc)
    for key in ("s_a", "s_p"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5)


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tapi.init_linear(torch.Generator().manual_seed(0), 8, 4,
                         TCIMConfig(enabled=True))
    assert resolve_device("cpu").type == "cpu"


def test_interop_round_trip_with_int4_leaves():
    import ml_dtypes
    tree = {"a": np.arange(6, dtype=np.int8).reshape(2, 3) - 3,
            "b": [np.asarray([-8, 7, 0], dtype=ml_dtypes.int4),
                  np.float32(1.5)],
            "c": np.arange(4, dtype=np.uint8)}
    t = from_numpy_tree(tree, CPU)
    assert t["b"][0].dtype == torch.int8
    assert t["b"][0].tolist() == [-8, 7, 0]
    back = to_numpy_tree(t)
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["c"], tree["c"])
    assert back["b"][1] == np.float32(1.5)


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.api, repro_torch.interop, "
            "repro_torch.kernels.ops, repro_torch.kernels._build, "
            "repro_torch.models.resnet, repro_torch.data.pipeline\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[\s.])",
                     re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch_deploy.py"]
    for f in files:
        assert not pat.search(f.read_text()), f
