"""The port's CIM kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the kernels' plain PyTorch versions
(``repro_torch.kernels.ref``); the JAX side runs ``cim_matmul_pallas`` /
``cim_conv_pallas`` in interpret mode, as the JAX package's own tests do.
Same integer inputs, made with numpy from a seed; outputs agree at the
reference's kernel-vs-oracle tolerance (rtol 1e-5, atol 1e-4: both sum
the same float32 terms, but XLA may fuse a multiply and an add).

The split tile loop's ordered sum (``ref.ordered_sum`` of
``ref.shift_add_terms``) equals ``ref.shift_add`` bit for bit.

At psum_bits == 1 the port is held against the JAX kernel's dense body
only: the reference's occupancy-skip body drifts from its dense body
under the sign ADC (ROADMAP, faults). The CUDA kernel itself is held
against its plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nibble import occupancy_map as j_occupancy_map
from repro.core.nibble import pack_nibbles as j_pack_nibbles
from repro.kernels import ref as jref
from repro.kernels.cim_conv import cim_conv_pallas
from repro.kernels.cim_matmul import cim_matmul_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cim_adc_free import cim_conv_adc_free_cuda
from repro_torch.kernels.cim_conv import cim_conv_cuda, implicit_conv
from repro_torch.kernels.cim_matmul import cim_matmul_cuda


def _t(a):
    return torch.from_numpy(np.array(a))


def _matmul_case(seed, *, m=37, kt=3, rows=16, s=3, n=20, unsigned=False,
                 dmax=3, dead=True):
    """Integer activations, digit planes with dead columns and one fully
    dead (split, tile) plane, psum scales near the psum magnitude."""
    rng = np.random.RandomState(seed)
    if unsigned:
        a = rng.randint(0, 256, size=(m, kt, rows)).astype(np.uint8)
    else:
        a = rng.randint(-8, 8, size=(m, kt, rows)).astype(np.int8)
    d = rng.randint(-dmax, dmax + 1, size=(s, kt, rows, n)).astype(np.int8)
    if dead:
        d[:, :, :, 3:9] = 0                  # dead columns on every plane
        d[min(1, s - 1), 0] = 0              # a fully dead (split, tile)
    amax = 255 if unsigned else 8
    s_p = (0.5 + rng.rand(s, kt, n) * amax * dmax * np.sqrt(rows) / 4
           ).astype(np.float32)
    deq = (rng.randn(s, kt, n) * 0.1).astype(np.float32)
    occ = np.asarray(j_occupancy_map(jnp.asarray(d)))
    if dead:
        assert occ.min() == 0 and occ.max() == 1
    packed = np.asarray(j_pack_nibbles(jnp.asarray(d)))
    return a, d, packed, s_p, deq, occ


MATMUL_CASES = [
    # (variant, psum_bits, psum_quant, unsigned)
    ("dense", 4, True, False),
    ("occ", 4, True, False),
    ("nibble+occ", 8, True, True),
    ("nibble", 4, True, False),
    ("dense", 1, True, False),
    ("nibble+occ", 1, True, True),
    ("occ", 8, False, True),
]


@pytest.mark.parametrize("variant,psum_bits,psum_quant,unsigned", MATMUL_CASES)
def test_cim_matmul_matches_pallas(variant, psum_bits, psum_quant, unsigned):
    a, d, packed, s_p, deq, occ = _matmul_case(psum_bits, unsigned=unsigned)
    nibble, sparse = "nibble" in variant, "occ" in variant
    digits = packed if nibble else d
    # the reference's dense body at the sign ADC (its sparse body drifts)
    j_occ = jnp.asarray(occ) if sparse and psum_bits > 1 else None
    j_digits = digits if psum_bits > 1 else d
    want = np.asarray(cim_matmul_pallas(
        jnp.asarray(a), jnp.asarray(j_digits), jnp.asarray(s_p),
        jnp.asarray(deq), None, None, j_occ, psum_bits=psum_bits,
        psum_quant=psum_quant, interpret=True))
    got = ops.cim_matmul(_t(a), _t(digits), _t(s_p), _t(deq),
                         psum_bits=psum_bits, psum_quant=psum_quant,
                         occ=_t(occ) if sparse else None)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    plain = ops.cim_matmul(_t(a), _t(digits), _t(s_p), _t(deq),
                           psum_bits=psum_bits, psum_quant=psum_quant,
                           use_kernel=False)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_cim_matmul_batch_dims_and_oracle():
    a, d, _, s_p, deq, _ = _matmul_case(5, m=12)
    got = ops.cim_matmul(_t(a.reshape(3, 4, *a.shape[1:])), _t(d), _t(s_p),
                         _t(deq), psum_bits=4)
    assert got.shape == (3, 4, d.shape[-1])
    want = np.asarray(jref.cim_matmul_ref(
        jnp.asarray(a), jnp.asarray(d), jnp.asarray(s_p), jnp.asarray(deq),
        psum_bits=4))
    np.testing.assert_allclose(got.reshape(12, -1).numpy(), want, rtol=1e-5,
                               atol=1e-4)


def test_adc_quantize_ref_matches():
    rng = np.random.RandomState(0)
    p = np.round(rng.randn(50, 7) * 30).astype(np.float32)
    p[0, :3] = [0.0, 5.0, -5.0]
    s_p = np.abs(rng.randn(7)).astype(np.float32) * 10
    s_p[0] = 0.0                                    # the 1e-9 clamp
    s_p[1] = 10.0                                   # a tie: 5 / 10 = 0.5
    for bits in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            ref.adc_quantize_ref(_t(p), _t(s_p), bits).numpy(),
            np.asarray(jref.adc_quantize_ref(jnp.asarray(p),
                                             jnp.asarray(s_p), bits)))


def test_conv_pads_match_xla_rule():
    for size, k, stride in itertools.product((1, 2, 5, 7, 8, 16, 31, 32),
                                             (1, 2, 3, 5, 7), (1, 2, 3, 4)):
        for pad in ("SAME", "VALID", "same"):
            want = jax.lax.padtype_to_pads((size, size + 3), (k, k),
                                           (stride, stride), pad.upper())
            got = ref.conv_pads(size, size + 3, k, k, stride, pad)
            assert got == tuple((int(lo), int(hi)) for lo, hi in want), \
                (size, k, stride, pad)
    assert ref.conv_pads(8, 8, 3, 3, 1, ((1, 0), (0, 2))) == ((1, 0), (0, 2))
    with pytest.raises(ValueError):
        ref.conv_pads(8, 8, 3, 3, 1, "FULL")


@pytest.mark.parametrize("kh,stride,padding", [(3, 1, "SAME"), (3, 2, "VALID"),
                                               (1, 2, "SAME"), (2, 3, "SAME")])
def test_extract_conv_patches_exact(kh, stride, padding):
    a = np.random.RandomState(kh).randint(-8, 8, size=(2, 9, 7, 5)).astype(
        np.int8)
    cpa, kt = 2, 3
    want = np.asarray(jref.extract_conv_patches(jnp.asarray(a), kh, kh, stride,
                                                padding, kt, cpa))
    got = ref.extract_conv_patches(_t(a), kh, kh, stride, padding, kt, cpa)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


CONV_CASES = [
    # (kh, stride, padding, variant, psum_bits)
    (3, 1, "SAME", "occ", 4),
    (3, 2, "VALID", "nibble+occ", 4),
    (1, 2, "SAME", "nibble", 8),
    (3, 1, "SAME", "dense", 1),
]


@pytest.mark.parametrize("kh,stride,padding,variant,psum_bits", CONV_CASES)
def test_cim_conv_matches_pallas(kh, stride, padding, variant, psum_bits):
    rng = np.random.RandomState(kh * 10 + stride)
    cpa, kt, s, c_in, c_out = 4, 2, 3, 7, 10
    a = rng.randint(0, 8, size=(2, 7, 6, c_in)).astype(np.int8)
    d6 = rng.randint(-1, 2, size=(s, kt, kh, kh, cpa, c_out)).astype(np.int8)
    d6[:, 1, :, :, cpa - 1] = 0                  # padded channel slot
    d6[..., 2:4] = 0                             # dead output channels
    occ = np.asarray(j_occupancy_map(jnp.asarray(d6), conv=True))
    rows = kh * kh * cpa
    digits = d6.reshape(s, kt, rows, c_out)
    packed = np.asarray(j_pack_nibbles(jnp.asarray(d6))).reshape(
        s, kt, rows // 2, c_out)
    s_p = (0.5 + rng.rand(s, kt, c_out) * 6).astype(np.float32)
    deq = (rng.randn(s, kt, c_out) * 0.1).astype(np.float32)
    nibble, sparse = "nibble" in variant, "occ" in variant
    dig = packed if nibble else digits
    geo = dict(kh=kh, kw=kh, stride=stride, padding=padding, c_per_array=cpa,
               psum_bits=psum_bits)
    want = np.asarray(cim_conv_pallas(
        jnp.asarray(a), jnp.asarray(dig), jnp.asarray(s_p), jnp.asarray(deq),
        None, None, jnp.asarray(occ) if sparse else None, interpret=True,
        **geo))
    got = ops.cim_conv(_t(a), _t(dig), _t(s_p), _t(deq),
                       occ=_t(occ) if sparse else None, **geo)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    plain = ops.cim_conv(_t(a), _t(dig), _t(s_p), _t(deq), use_kernel=False,
                         **geo)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_wrappers_refuse_what_the_kernel_does_not_take():
    a, d, _, s_p, deq, _ = _matmul_case(1, m=4)
    with pytest.raises(ValueError, match="unsupported device"):
        cim_matmul_cuda(_t(a).to("meta"), _t(d).to("meta"), _t(s_p), _t(deq),
                        psum_bits=4)
    with pytest.raises(ValueError, match="do not match"):
        cim_conv_cuda(torch.zeros((1, 4, 4, 3), dtype=torch.int8),
                      torch.zeros((3, 1, 20, 5), dtype=torch.int8),
                      torch.ones(3, 1, 5), torch.ones(3, 1, 5), kh=3, kw=3,
                      stride=1, padding="SAME", c_per_array=2, psum_bits=4)
    with pytest.raises(ValueError, match="do not match"):
        cim_conv_adc_free_cuda(torch.zeros((1, 4, 4, 3), dtype=torch.int8),
                               torch.zeros((3, 1, 20, 5)),
                               torch.ones(3, 1, 5), kh=3, kw=3, stride=1,
                               padding="SAME", c_per_array=2)


@pytest.mark.parametrize("adc", [True, False])
@pytest.mark.parametrize("planes", ["int8", "nibble", "float32"])
def test_implicit_conv_launch_refuses_what_the_kernels_do_not_take(adc,
                                                                   planes):
    """The launch every CIM conv shares (K3 and K5 on the int8 tensor
    cores, ADC and ADC-free convs on float32 planes on the FP64 ones)
    checks its operands before it builds or launches anything: these
    refusals are the same on the CPU as on the card."""
    a = torch.zeros((2, 6, 6, 16), dtype=torch.int8)
    rows = 9 * 14 // (2 if planes == "nibble" else 1)
    dtype = {"int8": torch.int8, "nibble": torch.uint8,
             "float32": torch.float32}[planes]
    d = torch.zeros((3, 2, rows, 8), dtype=dtype)
    cols = torch.ones(3, 2, 8)
    geo = ref.conv_geometry(a.shape, 3, 3, 1, "SAME", 2, 14)
    kw = dict(s_p=cols, psum_bits=4, psum_quant=True) if adc else {}

    def launch(a_=a, d_=d, deq=cols, occ=None, g=geo):
        return implicit_conv("conv", a_, d_, deq, occ, g, **kw)
    with pytest.raises(TypeError, match="activation codes"):
        launch(a_=a.float())
    with pytest.raises(TypeError, match="digit planes"):
        launch(d_=d.double())
    with pytest.raises(ValueError, match="wrong rank"):
        launch(d_=d[0])
    with pytest.raises(ValueError, match="deq has shape"):
        launch(deq=cols[:, :, :4])
    with pytest.raises(ValueError, match="occ has shape"):
        launch(occ=torch.ones(3, 1, 8, dtype=torch.uint8))
    with pytest.raises(ValueError, match="do not cover"):
        launch(d_=d[:, :1], deq=cols[:, :1],
               g=ref.conv_geometry(a.shape, 3, 3, 1, "SAME", 1, 14))
    with pytest.raises(ValueError, match="contiguous"):
        launch(a_=a.transpose(1, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        launch()
    if adc:
        with pytest.raises(ValueError, match="s_p has shape"):
            implicit_conv("conv", a, d, cols, None, geo, s_p=cols[:1],
                          psum_bits=4, psum_quant=True)


@pytest.mark.parametrize("psum_bits,chunk", [(4, 1), (1, 2), (6, 3)])
def test_split_tile_loop_ordered_sum_matches_shift_add_and_pallas(psum_bits,
                                                                  chunk):
    """The split tile loop of the tensor-core matmul at small M: blocks
    write the per-(t, s) terms of their chunk of tiles, and the ordered
    pass adds them from 0.0, t outer and s inner. Its plain mirror
    (``ref.shift_add_terms`` per chunk, then ``ref.ordered_sum``) equals
    ``ref.shift_add`` bit for bit, and so the port's matmul; both match the
    reference's dense Pallas kernel."""
    a, d, _, s_p, deq, _ = _matmul_case(10 + psum_bits, m=8, kt=5, rows=32)
    psum = ref.adc_quantize_ref(ref._psum(_t(a), _t(d)), _t(s_p)[None],
                                psum_bits)
    deq_t = _t(deq)
    kt = deq.shape[1]
    terms = torch.cat([ref.shift_add_terms(psum[..., t0:t0 + chunk, :],
                                           deq_t[:, t0:t0 + chunk])
                       for t0 in range(0, kt, chunk)])
    assert terms.shape == (kt, 3, 8, 20)
    got = ref.ordered_sum(terms)
    assert torch.equal(got, ref.shift_add(psum, deq_t))
    assert torch.equal(got, cim_matmul_cuda(_t(a), _t(d), _t(s_p), deq_t,
                                            psum_bits=psum_bits))
    want = cim_matmul_pallas(jnp.asarray(a), jnp.asarray(d), jnp.asarray(s_p),
                             jnp.asarray(deq), None, None, None,
                             psum_bits=psum_bits, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
