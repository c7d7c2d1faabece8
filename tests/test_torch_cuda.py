"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the CIM matmul/conv kernel with the ADC (int8 tensor cores on
integer planes, small M and the split tile loop included), the ADC-free
matmul/conv, both on float32 digit planes that carry cell variation, and
the MoE experts kernel (every expert of a bank in one launch, with each
expert's filled-slot ``counts``); the ADC matmul at the zoo's long down
projections (kt up to 256, scales staged per step); a MoE decode step
captured in a CUDA graph; and the reduced zoo entries (MLA, the int8 KV
cache, qk-norm) deployed against emulate.

Skips where there is no CUDA device. Imports no JAX, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Each kernel and ``kernels/ref.py`` add the same float32 terms in the same
order with the same roundings (float-digit partial sums are exact in
float64 on both sides), so they must agree bit for bit; within the port,
deploy is bit-identical with emulate on the card as well (ResNet-20 and
the reduced MoE transformer), and adc_free with emulate at
``psum_quant=False``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import api
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.core.nibble import occupancy_map, pack_nibbles, unpack_nibbles
from repro_torch.core.variation import Sampler
from repro_torch.kernels import ref
from repro_torch.kernels.cim_adc_free import (cim_conv_adc_free_cuda,
                                              cim_matmul_adc_free_cuda)
from repro_torch.kernels.cim_conv import cim_conv_cuda
from repro_torch.kernels.cim_matmul import (cim_matmul_cuda,
                                            cim_matmul_experts_cuda)
from repro_torch.models import resnet

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel runs only on the card")

# chip_smoke.py's case tables and operand builder, shared with its phase 3b
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _case(seed, *, m, kt, rows, n, s=3, unsigned=False):
    g = torch.Generator().manual_seed(seed)
    if unsigned:
        a = torch.randint(0, 256, (m, kt, rows), generator=g, dtype=torch.uint8)
    else:
        a = torch.randint(-8, 8, (m, kt, rows), generator=g, dtype=torch.int8)
    d = torch.randint(-3, 4, (s, kt, rows, n), generator=g, dtype=torch.int8)
    d[:, :, :, 3:9] = 0                      # dead columns on every plane
    d[min(1, s - 1), 0] = 0                  # a fully dead (split, tile)
    amax = 255 if unsigned else 8
    s_p = 0.5 + torch.rand((s, kt, n), generator=g) * amax * rows ** 0.5
    deq = torch.randn((s, kt, n), generator=g) * 0.1
    packed = pack_nibbles(d) if rows % 2 == 0 else d
    return [x.cuda() for x in (a, d, packed, s_p, deq, occupancy_map(d))]


@pytest.mark.parametrize("variant,psum_bits,psum_quant,unsigned", [
    ("dense", 4, True, False), ("occ", 4, True, False),
    ("nibble+occ", 8, True, True), ("nibble", 4, True, False),
    ("dense", 1, True, False), ("nibble+occ", 1, True, True),
    ("occ", 8, False, True)])
@pytest.mark.parametrize("n", [16, 20, 64, 130])
def test_cim_matmul_bit_exact_with_plain(variant, psum_bits, psum_quant,
                                         unsigned, n):
    nibble, sparse = "nibble" in variant, "occ" in variant
    a, d, packed, s_p, deq, occ = _case(n, m=301, kt=2, n=n,
                                        rows=124 if nibble else 126,
                                        unsigned=unsigned)
    before = cim_matmul_cuda.launches
    got = cim_matmul_cuda(a, packed if nibble else d, s_p, deq,
                          occ if sparse else None, psum_bits=psum_bits,
                          psum_quant=psum_quant)
    torch.cuda.synchronize()
    assert cim_matmul_cuda.launches == before + 1
    if nibble:
        assert torch.equal(unpack_nibbles(packed), d)
    want = ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=psum_bits,
                              psum_quant=psum_quant)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kh,stride,padding,nibble", [
    (3, 1, "SAME", True), (3, 2, "SAME", False), (1, 2, "SAME", True),
    (3, 1, "VALID", False), (1, 1, "VALID", False)])
def test_cim_conv_bit_exact_with_plain(kh, stride, padding, nibble):
    g = torch.Generator().manual_seed(kh * 10 + stride)
    cpa, kt, s, c_in, c_out = 14, 3, 3, 40, 32
    a = torch.randint(0, 8, (4, 16, 16, c_in), generator=g, dtype=torch.int8)
    d6 = torch.randint(-1, 2, (s, kt, kh, kh, cpa, c_out), generator=g,
                       dtype=torch.int8)
    d6[:, -1, :, :, c_in - (kt - 1) * cpa:] = 0     # padded channel slots
    d6[..., 5:9] = 0                                 # dead output channels
    occ = occupancy_map(d6, conv=True)
    rows = kh * kh * cpa
    logical = d6.reshape(s, kt, rows, c_out)
    digits = (pack_nibbles(d6).reshape(s, kt, rows // 2, c_out) if nibble
              else logical)
    s_p = 0.5 + torch.rand((s, kt, c_out), generator=g) * 20
    deq = torch.randn((s, kt, c_out), generator=g) * 0.1
    a, digits, logical, s_p, deq, occ = (x.cuda() for x in (
        a, digits, logical, s_p, deq, occ))
    geo = dict(kh=kh, kw=kh, stride=stride, padding=padding, c_per_array=cpa,
               psum_bits=4)
    got = cim_conv_cuda(a, digits, s_p, deq, occ, **geo)
    want = ref.cim_conv_ref(a, logical, s_p, deq, **geo)
    assert torch.equal(got, want)


def _noisy(d, seed):
    """float32 planes carrying one cell-variation realization (sigma 0.3)."""
    theta = torch.randn(d.shape, generator=torch.Generator().manual_seed(seed))
    return (d.float().cpu() * torch.exp(0.3 * theta)).to(d.device)


@pytest.mark.parametrize("variant,unsigned", [
    ("dense", False), ("occ", True), ("nibble+occ", False), ("nibble", True),
    ("float", False), ("float+occ", True)])
@pytest.mark.parametrize("n", [16, 20, 64, 130])
def test_cim_matmul_adc_free_bit_exact_with_plain(variant, unsigned, n):
    nibble, sparse = "nibble" in variant, "occ" in variant
    a, d, packed, _, deq, occ = _case(n + 1, m=301, kt=2, n=n,
                                      rows=124 if nibble else 126,
                                      unsigned=unsigned)
    digits = packed if nibble else d
    if "float" in variant:
        digits = d = _noisy(d, n)
    before = cim_matmul_adc_free_cuda.launches
    got = cim_matmul_adc_free_cuda(a, digits, deq, occ if sparse else None)
    torch.cuda.synchronize()
    assert cim_matmul_adc_free_cuda.launches == before + 1
    assert torch.equal(got, ref.cim_matmul_adc_free_ref(a, d, deq))


@pytest.mark.parametrize("psum_bits,psum_quant,sparse", [
    (4, True, False), (1, True, True), (8, True, True), (4, False, False)])
def test_cim_matmul_float_planes_bit_exact_with_plain(psum_bits, psum_quant,
                                                      sparse):
    a, d, _, s_p, deq, occ = _case(psum_bits, m=517, kt=3, n=40, rows=126)
    noisy = _noisy(d, psum_bits)
    before = cim_matmul_cuda.float_launches
    got = cim_matmul_cuda(a, noisy, s_p, deq, occ if sparse else None,
                          psum_bits=psum_bits, psum_quant=psum_quant)
    torch.cuda.synchronize()
    assert cim_matmul_cuda.float_launches == before + 1
    want = ref.cim_matmul_ref(a, noisy, s_p, deq, psum_bits=psum_bits,
                              psum_quant=psum_quant)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kh,stride,padding,planes", [
    (3, 1, "SAME", "nibble"), (3, 2, "SAME", "float"), (1, 2, "SAME", "int8"),
    (3, 2, "VALID", "float"), (1, 1, "VALID", "nibble")])
def test_cim_conv_adc_free_and_float_planes_bit_exact_with_plain(
        kh, stride, padding, planes):
    g = torch.Generator().manual_seed(kh * 100 + stride)
    cpa, kt, s, c_in, c_out = 14, 3, 3, 40, 32
    a = torch.randint(0, 8, (4, 16, 16, c_in), generator=g, dtype=torch.int8)
    d6 = torch.randint(-1, 2, (s, kt, kh, kh, cpa, c_out), generator=g,
                       dtype=torch.int8)
    d6[:, -1, :, :, c_in - (kt - 1) * cpa:] = 0     # padded channel slots
    d6[..., 5:9] = 0                                 # dead output channels
    occ = occupancy_map(d6, conv=True)
    rows = kh * kh * cpa
    logical = d6.reshape(s, kt, rows, c_out)
    digits = logical
    if planes == "nibble":
        digits = pack_nibbles(d6).reshape(s, kt, rows // 2, c_out)
    elif planes == "float":
        digits = logical = _noisy(logical, kh)
    s_p = 0.5 + torch.rand((s, kt, c_out), generator=g) * 20
    deq = torch.randn((s, kt, c_out), generator=g) * 0.1
    a, digits, logical, s_p, deq, occ = (x.cuda() for x in (
        a, digits, logical, s_p, deq, occ))
    geo = dict(kh=kh, kw=kh, stride=stride, padding=padding, c_per_array=cpa)
    before = cim_conv_adc_free_cuda.launches
    got = cim_conv_adc_free_cuda(a, digits, deq, occ, **geo)
    assert cim_conv_adc_free_cuda.launches == before + 1
    assert torch.equal(got, ref.cim_conv_adc_free_ref(a, logical, deq, **geo))
    if planes == "float":
        got = cim_conv_cuda(a, digits, s_p, deq, occ, psum_bits=4, **geo)
        want = ref.cim_conv_ref(a, logical, s_p, deq, psum_bits=4, **geo)
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,kt,rows,n,unsigned,nibble,sparse",
                         chip_smoke.ADC_FREE_MATMUL_CASES)
def test_adc_free_tensor_core_matmul_bit_exact_with_plain(m, kt, rows, n,
                                                         unsigned, nibble,
                                                         sparse):
    """The tensor-core ADC-free matmul on integer planes: rows not a
    multiple of 32 (16-byte aligned or staged loads), N from 1 to 200,
    ragged M, many row blocks per persistent block, nibbles, dead
    planes."""
    a, d, packed, _, deq, occ = _case(m + n, m=m, kt=kt, rows=rows, n=n,
                                      unsigned=unsigned)
    digits = packed if nibble else d
    before = cim_matmul_adc_free_cuda.launches, \
        cim_matmul_adc_free_cuda.float_launches
    got = cim_matmul_adc_free_cuda(a, digits, deq, occ if sparse else None)
    torch.cuda.synchronize()
    assert (cim_matmul_adc_free_cuda.launches,
            cim_matmul_adc_free_cuda.float_launches) == (before[0] + 1,
                                                         before[1])
    assert torch.equal(got, ref.cim_matmul_adc_free_ref(a, d, deq))


def _implicit_case(seed, *, b, h, w, c_in, kh, cpa, n, unsigned):
    """(a, logical, nibble planes, deq, occ) on the card."""
    a, logical, packed, occ, deq = chip_smoke.implicit_conv_operands(
        torch, torch.Generator().manual_seed(seed), b, h, w, c_in, kh, kh,
        cpa, n, unsigned)
    return [x.cuda() for x in (a, logical, packed, deq, occ)]


@pytest.mark.parametrize("b,h,w,c_in,kh,stride,padding,cpa,n",
                         [c[:9] for c in chip_smoke.IMPLICIT_CONV_CASES])
@pytest.mark.parametrize("variant", ["int8+occ", "nibble+uint8"])
def test_adc_free_implicit_conv_bit_exact_with_plain(b, h, w, c_in, kh, stride,
                                                     padding, cpa, n,
                                                     variant):
    """The implicit-GEMM conv: C_in 3 to 64 at 14 channels per array
    (16-byte aligned pixels or not), odd and even sizes at stride 2 under
    SAME and VALID, 1x1 projections, row blocks across images, ragged M;
    int8 planes with the occupancy map, nibble planes under uint8 codes."""
    nibble = variant.startswith("nibble")
    a, logical, packed, deq, occ = _implicit_case(
        b * h + c_in, b=b, h=h, w=w, c_in=c_in, kh=kh, cpa=cpa, n=n,
        unsigned=nibble)
    geo = dict(kh=kh, kw=kh, stride=stride, padding=padding, c_per_array=cpa)
    before = (cim_conv_adc_free_cuda.launches,
              cim_matmul_adc_free_cuda.launches,
              ref.extract_conv_patches.cuda_gathers)
    got = cim_conv_adc_free_cuda(a, packed if nibble else logical, deq,
                                 None if nibble else occ, **geo)
    torch.cuda.synchronize()
    assert (cim_conv_adc_free_cuda.launches,
            cim_matmul_adc_free_cuda.launches,
            ref.extract_conv_patches.cuda_gathers) == (
                before[0] + 1, before[1], before[2])
    assert torch.equal(got, ref.cim_conv_adc_free_ref(a, logical, deq, **geo))


def test_resnet_adc_free_forward_gathers_no_patches_on_the_card():
    """The integer adc_free ResNet-20 forward: 20 implicit-GEMM conv
    launches, no ADC-free matmul launch, no patch gather in torch."""
    cfg, cim, params, state, x, packed = _small_resnet20()
    acfg = dataclasses.replace(cfg, cim=cim.replace(mode="adc_free"))
    before = (cim_conv_adc_free_cuda.launches,
              cim_matmul_adc_free_cuda.launches,
              ref.extract_conv_patches.cuda_gathers)
    y, _ = resnet.forward(packed, state, x, acfg, train=False)
    torch.cuda.synchronize()
    assert (cim_conv_adc_free_cuda.launches,
            cim_matmul_adc_free_cuda.launches,
            ref.extract_conv_patches.cuda_gathers) == (
                before[0] + 20, before[1], before[2])
    assert torch.isfinite(y).all()


def test_implicit_conv_wrapper_raises_on_what_the_kernel_does_not_take():
    a, logical, _, deq, _ = _implicit_case(0, b=2, h=6, w=6, c_in=16, kh=3,
                                           cpa=14, n=8, unsigned=False)
    geo = dict(kh=3, kw=3, stride=1, padding="SAME", c_per_array=14)
    with pytest.raises(TypeError):                    # float codes
        cim_conv_adc_free_cuda(a.float(), logical, deq, **geo)
    with pytest.raises(ValueError):                   # deq of the wrong shape
        cim_conv_adc_free_cuda(a, logical, deq[:, :, :4], **geo)
    with pytest.raises(ValueError):                   # codes not contiguous
        cim_conv_adc_free_cuda(a.transpose(1, 2), logical, deq, **geo)
    with pytest.raises(ValueError):                   # planes on the CPU
        cim_conv_adc_free_cuda(a, logical.cpu(), deq, **geo)
    with pytest.raises(ValueError):                   # rows not kh*kw*cpa
        cim_conv_adc_free_cuda(a, logical[:, :, :120].contiguous(), deq,
                               **geo)
    with pytest.raises(ValueError):                   # tiles miss channels
        cim_conv_adc_free_cuda(a, logical[:, :1].contiguous(),
                               deq[:, :1].contiguous(), **geo)


def test_adc_free_kernels_relay_planes_after_an_in_place_write():
    """The relaid planes are kept per plane tensor: launches on the same
    planes, or on one expert's slice of a bank, read the kept copy, and
    an in-place write to the planes makes the next launch relay them."""
    a, d, _, _, deq, _ = _case(11, m=300, kt=2, rows=128, n=40)
    bank = torch.stack([d, d.flip(0)])                # two experts
    for _ in range(2):
        for e in range(2):
            assert torch.equal(
                cim_matmul_adc_free_cuda(a, bank[e], deq),
                ref.cim_matmul_adc_free_ref(a, bank[e], deq))
    bank[1, :, 0] = bank[1, :, 0].flip(-1)            # write one expert
    for e in range(2):
        assert torch.equal(cim_matmul_adc_free_cuda(a, bank[e], deq),
                           ref.cim_matmul_adc_free_ref(a, bank[e], deq))

    a, logical, _, deq, occ = _implicit_case(12, b=3, h=8, w=8, c_in=16, kh=3,
                                             cpa=14, n=24, unsigned=True)
    geo = dict(kh=3, kw=3, stride=1, padding="SAME", c_per_array=14)
    for _ in range(2):
        assert torch.equal(
            cim_conv_adc_free_cuda(a, logical, deq, occ, **geo),
            ref.cim_conv_adc_free_ref(a, logical, deq, **geo))
    logical[0] = logical[0].flip(-1)
    assert torch.equal(cim_conv_adc_free_cuda(a, logical, deq, None, **geo),
                       ref.cim_conv_adc_free_ref(a, logical, deq, **geo))


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    a, d, _, s_p, deq, _ = _case(2, m=8, kt=1, rows=16, n=8)
    with pytest.raises(TypeError):                    # float64 planes
        cim_matmul_cuda(a, d.double(), s_p, deq, psum_bits=4)
    with pytest.raises(TypeError):                    # float activations
        cim_matmul_cuda(a.float(), d, s_p, deq, psum_bits=4)
    with pytest.raises(ValueError):                   # planes left on the CPU
        cim_matmul_cuda(a, d.cpu(), s_p, deq, psum_bits=4)
    with pytest.raises(TypeError):
        cim_matmul_adc_free_cuda(a, d.half(), deq)
    with pytest.raises(ValueError):                   # deq of the wrong shape
        cim_matmul_adc_free_cuda(a, d, deq[:, :, :4])


def _small_resnet20():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                    act_bits=3, psum_bits=4, array_rows=128, array_cols=128,
                    act_signed=False, pack_dtype="int4")
    cfg = resnet.ResNetConfig(name="r20", depth=20, n_classes=10, in_hw=16,
                              cim=cim)
    params, state = resnet.init(0, cfg)
    x = torch.randn((8, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    params = resnet.calibrate(params, state, x, cfg)
    return cfg, cim, params, state, x, api.pack_model(params, cim)


def test_resnet_deploy_bit_exact_with_emulate_on_the_card():
    cfg, cim, params, state, x, packed = _small_resnet20()
    y_e, _ = resnet.forward(params, state, x, cfg, train=False)
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    before = cim_conv_cuda.launches
    y_d, _ = resnet.forward(packed, state, x, dcfg, train=False)
    assert cim_conv_cuda.launches == before + 20
    assert y_d.is_cuda and torch.isfinite(y_d).all()
    assert torch.equal(y_d, y_e)


def test_resnet_adc_free_equals_emulate_without_psum_quant_on_the_card():
    cfg, cim, params, state, x, packed = _small_resnet20()
    ecfg = dataclasses.replace(cfg, cim=cim.replace(psum_quant=False))
    y_e, _ = resnet.forward(params, state, x, ecfg, train=False)
    acfg = dataclasses.replace(cfg, cim=cim.replace(mode="adc_free"))
    before = (cim_conv_adc_free_cuda.launches, cim_conv_cuda.launches)
    y_a, _ = resnet.forward(packed, state, x, acfg, train=False)
    assert (cim_conv_adc_free_cuda.launches, cim_conv_cuda.launches) == (
        before[0] + 20, before[1])
    assert y_a.is_cuda and torch.isfinite(y_a).all()
    torch.testing.assert_close(y_a, y_e, rtol=1e-4, atol=1e-4)


def test_resnet_varied_deploy_equals_emulate_on_the_card():
    cfg, cim, params, state, x, packed = _small_resnet20()
    kw = dict(train=False, variation=Sampler(3), variation_std=0.3)
    y_e, _ = resnet.forward(params, state, x, cfg, **kw)
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    before = cim_conv_cuda.float_launches
    y_d, _ = resnet.forward(packed, state, x, dcfg, **kw)
    assert cim_conv_cuda.float_launches == before + 20
    torch.testing.assert_close(y_d, y_e, rtol=1e-4, atol=1e-4)
    clean, _ = resnet.forward(packed, state, x, dcfg, train=False)
    assert not torch.equal(y_d, clean)


def _experts_case(seed, *, e, c, kt, rows, n, s=2, unsigned=False):
    """An MoE bank of ``e`` experts: codes (E, C, kt, rows) with expert 0's
    rows all zero (an empty capacity buffer), planes with dead columns
    and a dead (split, tile) on expert 1, their nibble form, scales and
    occupancy maps."""
    g = torch.Generator().manual_seed(seed)
    if unsigned:
        a = torch.randint(0, 256, (e, c, kt, rows), generator=g,
                          dtype=torch.uint8)
    else:
        a = torch.randint(-128, 128, (e, c, kt, rows), generator=g,
                          dtype=torch.int8)
    a[0] = 0
    d = torch.randint(-3, 4, (e, s, kt, rows, n), generator=g,
                      dtype=torch.int8)
    d[..., 3:9] = 0
    if e > 1:
        d[1, min(1, s - 1), 0] = 0
    amax = 255 if unsigned else 128
    s_p = 0.5 + torch.rand((e, s, kt, n), generator=g) * amax * rows ** 0.5 / 8
    deq = torch.randn((e, s, kt, n), generator=g) * 0.1
    return [x.cuda() for x in (a, d, pack_nibbles(d), s_p, deq,
                               occupancy_map(d))]


@pytest.mark.parametrize("e,c,kt,rows,n", [
    (1, 64, 16, 128, 1408), (8, 61, 3, 128, 100), (64, 48, 16, 128, 64),
    (8, 5, 2, 126, 17)])
@pytest.mark.parametrize("variant,psum_bits,psum_quant,unsigned", [
    ("dense", 4, True, False), ("nibble+occ", 6, True, False),
    ("occ", 1, True, True), ("nibble", 8, True, True),
    ("nibble+occ", 6, False, False)])
def test_cim_matmul_experts_bit_exact_with_plain(e, c, kt, rows, n, variant,
                                                 psum_bits, psum_quant,
                                                 unsigned):
    nibble, sparse = "nibble" in variant, "occ" in variant
    a, d, packed, s_p, deq, occ = _experts_case(
        e + c + n, e=e, c=c, kt=kt, rows=rows, n=n, unsigned=unsigned)
    before = cim_matmul_experts_cuda.launches
    got = cim_matmul_experts_cuda(a, packed if nibble else d, s_p, deq,
                                  occ if sparse else None,
                                  psum_bits=psum_bits, psum_quant=psum_quant)
    torch.cuda.synchronize()
    assert cim_matmul_experts_cuda.launches == before + 1
    want = ref.cim_matmul_experts_ref(a, d, s_p, deq, psum_bits=psum_bits,
                                      psum_quant=psum_quant)
    assert got.shape == (e, c, n)
    assert torch.equal(got, want)
    # expert by expert, the single-matrix kernel gives the same bits
    loop = torch.stack([
        cim_matmul_cuda(a[i], (packed if nibble else d)[i], s_p[i], deq[i],
                        occ[i] if sparse else None, psum_bits=psum_bits,
                        psum_quant=psum_quant) for i in range(e)])
    assert torch.equal(got, loop)


def test_experts_wrapper_raises_on_what_the_kernel_does_not_take():
    a, d, _, s_p, deq, _ = _experts_case(0, e=2, c=4, kt=1, rows=16, n=8)
    with pytest.raises(TypeError):                    # float (varied) planes
        cim_matmul_experts_cuda(a, d.float(), s_p, deq, psum_bits=4)
    with pytest.raises(ValueError):                   # planes of 3 experts
        cim_matmul_experts_cuda(a, torch.cat([d, d[:1]]), s_p, deq,
                                psum_bits=4)
    with pytest.raises(ValueError):                   # one expert's codes
        cim_matmul_experts_cuda(a[0], d, s_p, deq, psum_bits=4)


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_moe_transformer_deploy_bit_exact_with_emulate_on_the_card(
        pack_dtype):
    """The reduced moonshot transformer (1 dense layer, 1 MoE layer of 8
    experts) in bfloat16, 128-row arrays: its deploy logits, through K1
    and one K6 launch per expert bank, equal its emulate logits."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                    act_bits=8, psum_bits=6, array_rows=128, array_cols=128,
                    pack_dtype=pack_dtype)
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True, cim=cim)
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0)
    tokens = torch.randint(0, cfg.vocab, (4, 40), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    y_e = model.forward(params, tokens, cfg)
    art = api.model_artifact(params, cim)
    dcfg = cfg.replace(cim=art.config)
    before = (cim_matmul_experts_cuda.launches, cim_matmul_cuda.launches)
    y_d = model.forward(art.params, tokens, dcfg)
    torch.cuda.synchronize()
    assert cim_matmul_experts_cuda.launches == before[0] + 3
    assert cim_matmul_cuda.launches == before[1] + 7 + 7
    assert y_d.dtype == torch.bfloat16 and torch.isfinite(y_d).all()
    assert torch.equal(y_d, y_e)


@pytest.mark.parametrize("arch,kv_cache_dtype,k1_fwd", [
    ("deepseek-v3-671b", "bf16", 16), ("llama3-8b", "int8", 14),
    ("qwen3-0.6b", "bf16", 14)])
def test_zoo_transformer_deploy_bit_exact_with_emulate_on_the_card(
        arch, kv_cache_dtype, k1_fwd):
    """The reduced zoo entries in bfloat16 with 128-row arrays (deepseek's
    MLA as its dense layer only, ``moe=None``; llama3 with the int8 KV
    cache): deploy logits through K1 alone equal emulate's, and so do a
    few greedy decode steps through the cache."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                    act_bits=8, psum_bits=6, array_rows=128, array_cols=128)
    cfg = get_config(arch, reduced=True, cim=cim).replace(
        moe=None, kv_cache_dtype=kv_cache_dtype)
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0)
    tokens = torch.randint(0, cfg.vocab, (4, 40), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    art = api.model_artifact(params, cim)
    dcfg = cfg.replace(cim=art.config)

    def run(p, c):
        cache = model.init_cache(c, 4, 48)
        logits, cache = model.decode_step(p, cache, tokens, c)
        outs = [logits]
        for _ in range(4):
            tok = torch.argmax(logits[:, -1:].float(), -1).to(torch.int32)
            logits, cache = model.decode_step(p, cache, tok, c)
            outs.append(logits)
        return model.forward(p, tokens, c), outs
    y_e, dec_e = run(params, cfg)
    before = cim_matmul_cuda.launches
    y_d, dec_d = run(art.params, dcfg)
    torch.cuda.synchronize()
    assert cim_matmul_cuda.launches == before + 6 * k1_fwd
    assert y_d.dtype == torch.bfloat16 and torch.isfinite(y_d).all()
    assert torch.equal(y_d, y_e)
    assert all(torch.equal(d, e) for d, e in zip(dec_d, dec_e))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b",
                                  "whisper-small", "llava-next-mistral-7b"])
def test_recurrent_and_multimodal_deploy_bit_exact_with_emulate_on_the_card(
        arch):
    """The reduced recurrent and multimodal entries in bfloat16 with
    128-row arrays: the forward with the front-end input (whisper's log-mel
    frames through its stem, llava's images through the patch embed, with
    patch 14 on 28 x 28 images: 196-row tiles) and a few decode steps
    through the cache (whisper's with the encoder states) on deploy equal
    emulate's; K1 and K3 launch as many times as the spec tree's CIM
    nodes say, with no patch gather in torch; for zamba2 and xlstm, whose
    steps write their states in place, a decode step replayed from a CUDA
    graph equals the eager step, logits and caches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import whisper
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                    act_bits=8, psum_bits=6, array_rows=128, array_cols=128)
    cfg = get_config(arch, reduced=True, cim=cim)
    if cfg.family == "llava":
        cfg = cfg.replace(patch_size=14, n_frontend_tokens=4)
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0)
    gen = torch.Generator("cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (4, 20), device="cuda",
                           generator=gen)
    extra = chip_smoke.frontend_batch(torch, cfg, 4)
    art = api.model_artifact(params, cim)
    dcfg = cfg.replace(cim=art.config)
    (k1_fwd, k3_fwd), k1_step = chip_smoke.recurrent_zoo_counts(cfg)

    def run(p, c):
        cache = model.init_cache(c, 4, 32)
        if cfg.family == "whisper":
            cache["enc_out"] = whisper.encode(p, extra, c)
        logits, cache = model.decode_step(p, cache, tokens, c)
        outs = [logits]
        for _ in range(3):
            tok = torch.argmax(logits[:, -1:].float(), -1).to(torch.int32)
            logits, cache = model.decode_step(p, cache, tok, c)
            outs.append(logits)
        return model.forward(p, tokens, c, extra), outs, cache
    y_e, dec_e, _ = run(params, cfg)
    before = (cim_matmul_cuda.launches, cim_conv_cuda.launches,
              ref.extract_conv_patches.cuda_gathers)
    y_d, dec_d, cache = run(art.params, dcfg)
    torch.cuda.synchronize()
    enc = (k1_fwd - k1_step, k3_fwd) if cfg.family == "whisper" else (0, 0)
    assert (cim_matmul_cuda.launches, cim_conv_cuda.launches,
            ref.extract_conv_patches.cuda_gathers) == (
                before[0] + k1_fwd + 4 * k1_step + enc[0],
                before[1] + k3_fwd + enc[1], before[2])
    assert torch.isfinite(y_d).all()
    assert torch.equal(y_d, y_e)
    assert all(torch.equal(d, e) for d, e in zip(dec_d, dec_e))
    if cfg.family not in ("zamba2", "xlstm"):
        return
    from repro_torch import tree_leaves, tree_map
    tok = torch.argmax(dec_d[-1][:, -1:].float(), -1).to(torch.int32)
    snap = tree_map(lambda t: t.clone(), cache)
    eager, eager_cache = model.decode_step(art.params, cache, tok, dcfg)
    eager_cache = tree_map(lambda t: t.clone(), eager_cache)
    tree_map(lambda d, s: d.copy_(s), cache, snap)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, out_cache = model.decode_step(art.params, cache, tok, dcfg)
    graph.replay()
    tree_map(lambda d, s: d is s or d.copy_(s), cache, out_cache)
    torch.cuda.synchronize()
    assert torch.equal(logits, eager)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(cache),
                                                  tree_leaves(eager_cache)))


@pytest.mark.parametrize(
    "m,kt,rows,n,unsigned,nibble,sparse,psum_bits,psum_quant",
    chip_smoke.SMALL_M_CASES)
def test_cim_matmul_small_m_bit_exact_with_plain(m, kt, rows, n, unsigned,
                                                 nibble, sparse, psum_bits,
                                                 psum_quant):
    """The tensor-core ADC matmul at decode's row counts (M 1, 8, 16, 33):
    one-warp row blocks, 16-column tiles, the split tile loop with its
    ordered pass, N from 1 to 11264, rows 126 (staged) and 128 (direct),
    psum_bits 1/4/6/8 and psum_quant off; sparse equals dense under the
    sign ADC."""
    a, d, digits, occ, s_p, deq = (x.cuda() for x in chip_smoke
                                   ._matmul_operands(torch, torch.Generator()
                                                     .manual_seed(m + n + kt),
                                                     m, kt, rows, n, unsigned,
                                                     nibble))
    kw = dict(psum_bits=psum_bits, psum_quant=psum_quant)
    before = cim_matmul_cuda.launches
    got = cim_matmul_cuda(a, digits, s_p, deq, occ if sparse else None, **kw)
    dense = cim_matmul_cuda(a, digits, s_p, deq, None, **kw)
    torch.cuda.synchronize()
    assert cim_matmul_cuda.launches == before + 2
    want = ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=psum_bits,
                              psum_quant=psum_quant)
    assert torch.equal(got, want)
    assert torch.equal(dense, want)


@pytest.mark.parametrize("e,c,kt,rows,n,counts", [
    (8, 61, 3, 128, 100, [0, 61, 1, 17, 33, 48, 60, 5]),
    (64, 48, 4, 128, 64, None),
    (4, 5, 2, 126, 17, [5, 0, 2, 3])])
@pytest.mark.parametrize("variant,psum_bits,unsigned", [
    ("dense", 6, False), ("nibble+occ", 1, True), ("occ", 4, False)])
def test_cim_matmul_experts_counts_bit_exact_with_plain(e, c, kt, rows, n,
                                                        counts, variant,
                                                        psum_bits, unsigned):
    """The experts kernel with ``counts``: an empty expert, a full one and
    ragged ones (decode-like: most experts hold a row or none). Rows below
    counts[e] equal the kernel without counts; the output equals the
    plain version with counts, and a per-expert loop of the matmul kernel
    on codes zeroed past them, bit for bit."""
    nibble, sparse = "nibble" in variant, "occ" in variant
    a, d, packed, s_p, deq, occ = _experts_case(
        e + c + n, e=e, c=c, kt=kt, rows=rows, n=n, unsigned=unsigned)
    if counts is None:                     # 48 pairs over 64 experts
        g = torch.Generator().manual_seed(e)
        counts = torch.bincount(torch.randint(0, e, (c,), generator=g),
                                minlength=e).tolist()
    cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
    digits = packed if nibble else d
    kw = dict(psum_bits=psum_bits)
    o = occ if sparse else None
    before = cim_matmul_experts_cuda.launches
    got = cim_matmul_experts_cuda(a, digits, s_p, deq, o, counts=cnt, **kw)
    full = cim_matmul_experts_cuda(a, digits, s_p, deq, o, **kw)
    torch.cuda.synchronize()
    assert cim_matmul_experts_cuda.launches == before + 2
    assert torch.equal(got, ref.cim_matmul_experts_ref(a, d, s_p, deq,
                                                       counts=cnt, **kw))
    a0 = a.clone()
    for j, cj in enumerate(counts):
        assert torch.equal(got[j, :cj], full[j, :cj])
        a0[j, cj:] = 0
    loop = torch.stack([cim_matmul_cuda(a0[i], digits[i], s_p[i], deq[i],
                                        None if o is None else o[i], **kw)
                        for i in range(e)])
    assert torch.equal(got, loop)
    with pytest.raises(ValueError):               # counts of the wrong type
        cim_matmul_experts_cuda(a, digits, s_p, deq, o, counts=cnt.long(),
                                **kw)


def test_matmul_and_adc_free_launches_share_the_relaid_planes():
    """The ADC matmul and the ADC-free matmul on the same planes keep one
    relaid copy (their layout ids agree); the experts kernel relays a bank
    as one tensor."""
    from repro_torch.kernels import relaid
    relaid.clear_relaid_planes()
    a, d, _, s_p, deq, _ = _case(21, m=40, kt=2, rows=128, n=64)
    cim_matmul_cuda(a, d, s_p, deq, psum_bits=4)
    kept = [w for per in relaid._KEPT.values() for w in per.values()]
    assert len(kept) == 1
    layout = kept[0][2].value
    assert torch.equal(cim_matmul_adc_free_cuda(a, d, deq),
                       ref.cim_matmul_adc_free_ref(a, d, deq))
    kept = [w for per in relaid._KEPT.values() for w in per.values()]
    assert len(kept) == 1 and kept[0][2].value == layout
    relaid.clear_relaid_planes()


def _reduced_moe(pack_dtype="int8"):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                    act_bits=8, psum_bits=6, array_rows=128, array_cols=128,
                    pack_dtype=pack_dtype)
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True, cim=cim)
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0)
    return cfg, model, params


def test_moe_decode_step_replays_from_a_cuda_graph_with_counts():
    """A deploy decode step of the reduced moonshot transformer, captured
    once in a CUDA graph: the experts' ``counts`` come from the device (no
    host sync), the K6 launches take them, and replaying the graph gives
    the tokens of the eager decode loop."""
    import repro_torch.kernels.ops as kops
    cfg, model, params = _reduced_moe()
    art = api.model_artifact(params, cfg.cim)
    dcfg = cfg.replace(cim=art.config)
    p = art.params
    b, steps = 4, 6
    tokens = torch.randint(0, cfg.vocab, (b, 12), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))

    def prompt():
        cache = model.init_cache(cfg, b, 32)
        logits, cache = model.decode_step(p, cache, tokens, dcfg)
        return torch.argmax(logits[:, -1:].float(), -1).to(torch.int32), cache

    tok, cache = prompt()
    eager = []
    for _ in range(steps):
        logits, cache = model.decode_step(p, cache, tok, dcfg)
        tok = torch.argmax(logits[:, -1:].float(), -1).to(torch.int32)
        eager.append(tok)

    tok, cache = prompt()
    static = tok.clone()
    seen = []
    orig = kops.cim_matmul_experts_cuda

    def spy(*args, **kw):
        seen.append(kw.get("counts"))
        return orig(*args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    kops.cim_matmul_experts_cuda = spy
    try:
        with torch.cuda.stream(side):
            warm = {k: v["len"].clone() for k, v in cache.items()}
            model.decode_step(p, cache, static, dcfg)   # warm-up, then undo
            for k, v in cache.items():
                v["len"].copy_(warm[k])
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            logits, out_cache = model.decode_step(p, cache, static, dcfg)
            nxt = torch.argmax(logits[:, -1:].float(), -1).to(torch.int32)
    finally:
        kops.cim_matmul_experts_cuda = orig
    assert seen and all(c is not None and c.dtype == torch.int32
                        for c in seen)
    replayed = []
    for _ in range(steps):
        graph.replay()
        for k, v in cache.items():
            v["len"].copy_(out_cache[k]["len"])
        static.copy_(nxt)
        replayed.append(nxt.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(replayed, eager))


@pytest.mark.parametrize("psum_bits,sp_scale", [(6, 1.0), (23, 1.0),
                                                (4, 1e31), (8, 1e-20)])
def test_cim_matmul_adc_divide_paths_bit_exact_with_plain(psum_bits,
                                                          sp_scale):
    """The ADC's divide: from the column's reciprocal where every scale of
    a block lies in [2^-100, 2^100] and psum_bits <= 22, else by the IEEE
    divide; both give the plain version's bits (scales of 1e31 and 1e-20,
    and 23-bit partial sums, take the second)."""
    a, d, _, s_p, deq, occ = _case(psum_bits, m=200, kt=3, rows=128, n=48)
    s_p = s_p * sp_scale
    if sp_scale > 1:
        s_p[0, 0, :8] = 1.0            # one block mixes the two ranges
    got = cim_matmul_cuda(a, d, s_p, deq, occ, psum_bits=psum_bits)
    want = ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=psum_bits)
    assert torch.equal(got, want)


# K1 at the zoo's long down projections, where each step's tile scales are
# staged beside its digits (ROADMAP fault 7): M 512 (prefill) and 8
# (decode) at kt 112 (llama3-8b's wd), 128 (deepseek-v3's MLA wo), 144 (its
# dense wd) and 256, N 7168 (64-column tiles at M 512) and 4096 (32), and
# N 576 at kt 56 (MLA's wkv_a); the serving launcher's S = 2 and 6-bit
# partial sums
LONG_K_CASES = ([(m, kt, n) for m in (512, 8) for kt in (112, 128, 144, 256)
                 for n in (7168, 4096)] + [(512, 56, 576), (8, 56, 576)])


@pytest.mark.parametrize("m,kt,n", LONG_K_CASES)
def test_cim_matmul_long_k_plans_and_is_bit_exact_with_plain(m, kt, n):
    """The launch plans and runs at any kt up to 256, int8 and nibble
    planes, and equals the plain version bit for bit."""
    a, d, packed, s_p, deq, occ = _case(m + kt + n, m=m, kt=kt, rows=128,
                                        n=n, s=2)
    want = ref.cim_matmul_ref(a, d, s_p, deq, psum_bits=6)
    for digits in (d, packed):
        before = cim_matmul_cuda.launches
        got = cim_matmul_cuda(a, digits, s_p, deq, occ, psum_bits=6)
        torch.cuda.synchronize()
        assert cim_matmul_cuda.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("psum_bits,psum_quant,sp_scale", [
    (1, True, 1.0), (4, True, 1e31), (6, True, 1.0), (8, False, 1.0)])
def test_per_step_scales_in_every_adc_mode_bit_exact_with_plain(
        psum_bits, psum_quant, sp_scale):
    """Scales staged per step (kt 130: the digit tiles cannot stay
    resident) under the sign ADC, the IEEE divide (scales of 1e31 mixed
    with 1.0 in one block), the reciprocal and psum_quant off; and the
    experts kernel's zero-row value under the sign ADC, computed from the
    scales in device memory."""
    a, d, packed, s_p, deq, occ = _case(psum_bits, m=300, kt=130, rows=128,
                                        n=200, s=2)
    s_p = s_p * sp_scale
    if sp_scale > 1:
        s_p[0, 0, :8] = 1.0
    kw = dict(psum_bits=psum_bits, psum_quant=psum_quant)
    want = ref.cim_matmul_ref(a, d, s_p, deq, **kw)
    assert torch.equal(cim_matmul_cuda(a, packed, s_p, deq, occ, **kw), want)
    counts = torch.tensor([0, 40, 3], dtype=torch.int32, device="cuda")
    ea, ed, es, eq = (x[None].expand(3, *x.shape).contiguous()
                      for x in (a[:40], d, s_p, deq))
    got = cim_matmul_experts_cuda(ea, ed, es, eq, counts=counts, **kw)
    assert torch.equal(got, ref.cim_matmul_experts_ref(ea, ed, es, eq,
                                                       counts=counts, **kw))


def _adc_case_id(c):
    kw = "" if c[5] == c[4] else f"-kw{c[5]}"
    return "x".join(map(str, c[:5])) + f"{kw}-s{c[6]}-n{c[9]}-b{c[11]}"


@pytest.mark.parametrize("case", chip_smoke.IMPLICIT_ADC_CONV_CASES,
                         ids=_adc_case_id)
def test_implicit_adc_conv_bit_exact_with_plain(case):
    """K3 as an implicit GEMM with the ADC epilogue, on chip_smoke.py's
    phase-3 grid, the zoo's front ends included (whisper's 1x3 stem convs
    on H = 1, llava's 14x14 patch embed on 196-row tiles): int8 and int4
    planes, with and without the occupancy map, all four equal to the
    plain conv (sparse equals dense under the sign ADC too); no matmul
    launch and no patch gather in torch."""
    b, h, w, c_in, kh, kw, stride, padding, cpa, n, uns, pb, quant = case
    a, logical, packed, occ, s_p, deq = (
        x.cuda() for x in chip_smoke.implicit_adc_conv_operands(
            torch, torch.Generator().manual_seed(sum(case[:5]) + stride + n),
            b, h, w, c_in, kh, kw, cpa, n, uns))
    geo = dict(kh=kh, kw=kw, stride=stride, padding=padding, c_per_array=cpa,
               psum_bits=pb, psum_quant=quant)
    before = (cim_conv_cuda.launches, cim_matmul_cuda.launches,
              ref.extract_conv_patches.cuda_gathers)
    outs = [cim_conv_cuda(a, planes, s_p, deq, o, **geo)
            for planes in (logical, packed) for o in (None, occ)]
    torch.cuda.synchronize()
    assert (cim_conv_cuda.launches, cim_matmul_cuda.launches,
            ref.extract_conv_patches.cuda_gathers) == (
                before[0] + 4, before[1], before[2])
    want = ref.cim_conv_ref(a, logical, s_p, deq, **geo)
    for got in outs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("sigma", chip_smoke.VARIATION_SIGMAS)
@pytest.mark.parametrize("case", chip_smoke.FLOAT_CONV_CASES,
                         ids=_adc_case_id)
def test_float_plane_implicit_convs_bit_exact_with_plain(case, sigma):
    """The float-plane convs (cell variation at sigma 0.1-0.4) as implicit
    GEMMs on the FP64 tensor cores, with the ADC and ADC-free, against
    their plain versions; sparse equals dense; counted as float-plane
    launches, no matmul launch, no patch gather in torch."""
    b, h, w, c_in, kh, kw, stride, padding, cpa, n, uns, pb, quant = case
    g = torch.Generator().manual_seed(sum(case[:5]) + stride + n)
    a, logical, _, occ, s_p, deq = chip_smoke.implicit_adc_conv_operands(
        torch, g, b, h, w, c_in, kh, kw, cpa, n, uns)
    a, noisy, occ, s_p, deq = (x.cuda() for x in (
        a, chip_smoke.varied_planes(torch, g, logical, sigma), occ, s_p, deq))
    geo = dict(kh=kh, kw=kw, stride=stride, padding=padding, c_per_array=cpa)
    mq = dict(psum_bits=pb, psum_quant=quant)
    before = (cim_conv_cuda.float_launches,
              cim_conv_adc_free_cuda.float_launches,
              cim_matmul_cuda.launches, cim_matmul_adc_free_cuda.launches,
              ref.extract_conv_patches.cuda_gathers)
    adc = [cim_conv_cuda(a, noisy, s_p, deq, o, **geo, **mq)
           for o in (occ, None)]
    free = [cim_conv_adc_free_cuda(a, noisy, deq, o, **geo)
            for o in (occ, None)]
    torch.cuda.synchronize()
    assert (cim_conv_cuda.float_launches,
            cim_conv_adc_free_cuda.float_launches, cim_matmul_cuda.launches,
            cim_matmul_adc_free_cuda.launches,
            ref.extract_conv_patches.cuda_gathers) == (
                before[0] + 2, before[1] + 2, before[2], before[3], before[4])
    want = ref.cim_conv_ref(a, noisy, s_p, deq, **geo, **mq)
    want_free = ref.cim_conv_adc_free_ref(a, noisy, deq, **geo)
    assert torch.equal(adc[0], want) and torch.equal(adc[1], want)
    assert torch.equal(free[0], want_free) and torch.equal(free[1], want_free)


@pytest.mark.parametrize("psum_bits,sp_scale", [(6, 1.0), (23, 1.0),
                                                (4, 1e31), (8, 1e-20)])
def test_float_plane_conv_adc_divide_paths_bit_exact_with_plain(psum_bits,
                                                                sp_scale):
    """The float-plane conv's ADC divide, as the integer kernels': from
    the column's reciprocal where a tile's scales lie in [2^-100, 2^100]
    and psum_bits <= 22, else by the IEEE divide; both give the plain
    version's bits."""
    g = torch.Generator().manual_seed(psum_bits)
    a, logical, _, occ, s_p, deq = chip_smoke.implicit_adc_conv_operands(
        torch, g, 4, 8, 8, 16, 3, 3, 14, 24, True)
    s_p = s_p * sp_scale
    if sp_scale > 1:
        s_p[0, 0, :8] = 1.0            # one block mixes the two ranges
    a, noisy, occ, s_p, deq = (x.cuda() for x in (
        a, chip_smoke.varied_planes(torch, g, logical, 0.2), occ, s_p, deq))
    geo = dict(kh=3, kw=3, stride=1, padding="SAME", c_per_array=14,
               psum_bits=psum_bits)
    assert torch.equal(cim_conv_cuda(a, noisy, s_p, deq, occ, **geo),
                       ref.cim_conv_ref(a, noisy, s_p, deq, **geo))


def test_resnet_deploy_and_varied_forwards_gather_no_patches():
    """The deploy ResNet-20 forward and the varied one: 20 K3 launches
    each (the varied ones on float planes), no matmul launch, no patch
    gather in torch."""
    cfg, cim, params, state, x, packed = _small_resnet20()
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    before = (cim_conv_cuda.launches, cim_conv_cuda.float_launches,
              cim_matmul_cuda.launches, ref.extract_conv_patches.cuda_gathers)
    y, _ = resnet.forward(packed, state, x, dcfg, train=False)
    y_v, _ = resnet.forward(packed, state, x, dcfg, train=False,
                            variation=Sampler(5), variation_std=0.2)
    torch.cuda.synchronize()
    assert (cim_conv_cuda.launches, cim_conv_cuda.float_launches,
            cim_matmul_cuda.launches,
            ref.extract_conv_patches.cuda_gathers) == (
                before[0] + 40, before[1] + 20, before[2], before[3])
    assert torch.isfinite(y).all() and torch.isfinite(y_v).all()


def test_k3_and_k5_share_the_relaid_planes_and_the_window_mode():
    """The ADC and ADC-free implicit convs on the same planes keep one
    relaid copy; ``window_mode`` tells which convs copy their input window
    (ResNet-20's) and which take the staged path (a wide layer whose
    128-row window exceeds 32 KB)."""
    from repro_torch.kernels import relaid
    from repro_torch.kernels.cim_conv import window_mode
    relaid.clear_relaid_planes()
    a, logical, _, occ, s_p, deq = (
        x.cuda() for x in chip_smoke.implicit_adc_conv_operands(
            torch, torch.Generator().manual_seed(31), 3, 8, 8, 32, 3, 3, 14,
            24, True))
    geo = dict(kh=3, kw=3, stride=1, padding="SAME", c_per_array=14)
    assert torch.equal(cim_conv_cuda(a, logical, s_p, deq, occ, psum_bits=4,
                                     **geo),
                       ref.cim_conv_ref(a, logical, s_p, deq, psum_bits=4,
                                        **geo))
    kept = [w for per in relaid._KEPT.values() for w in per.values()]
    assert len(kept) == 1
    assert torch.equal(cim_conv_adc_free_cuda(a, logical, deq, occ, **geo),
                       ref.cim_conv_adc_free_ref(a, logical, deq, **geo))
    assert len([w for per in relaid._KEPT.values()
                for w in per.values()]) == 1
    relaid.clear_relaid_planes()
    assert window_mode(ref.conv_geometry((256, 32, 32, 16), 3, 3, 1, "SAME",
                                         2, 14), 3, 16)
    assert not window_mode(ref.conv_geometry((64, 8, 8, 256), 3, 3, 1,
                                             "SAME", 19, 14), 3, 256)


def _unshowable_planes(logical):
    """float32 planes whose first column spans 2^40 between its largest
    and least nonzero digit: past what the float-digit kernel can show
    exact (``float_sums_exact``)."""
    planes = logical.to(torch.float32).clone()
    planes[0, 0, :, 0] = 1.0
    planes[0, 0, 0, 0] = 2.0 ** 40
    return planes


def test_float_launches_raise_where_exactness_cannot_be_shown():
    """A float-plane launch whose tile sums the bound cannot show exact
    raises with the planes' shape in the message (the conv also with its
    geometry), and launches nothing; on the same planes with the column
    back in range it runs and equals its plain version."""
    g = torch.Generator().manual_seed(41)
    a, logical, _, occ, s_p, deq = chip_smoke.implicit_adc_conv_operands(
        torch, g, 2, 28, 42, 3, 14, 14, 1, 40, True)
    a, logical, s_p, deq = (x.cuda() for x in (a, logical, s_p, deq))
    geo = dict(kh=14, kw=14, stride=14, padding="VALID", c_per_array=1)
    bad = _unshowable_planes(logical)
    before = (cim_conv_cuda.launches, cim_conv_adc_free_cuda.launches,
              cim_matmul_cuda.launches, cim_matmul_adc_free_cuda.launches)
    with pytest.raises(ValueError, match=r"planes \(3, 3, 196, 40\).*14x14"):
        cim_conv_cuda(a, bad, s_p, deq, psum_bits=6, **geo)
    with pytest.raises(ValueError, match="cannot show exact"):
        cim_conv_adc_free_cuda(a, bad, deq, **geo)
    a_t = torch.randint(0, 256, (8, 3, 196), generator=g,
                        dtype=torch.uint8).cuda()
    with pytest.raises(ValueError, match=r"planes \(3, 3, 196, 40\)"):
        cim_matmul_cuda(a_t, bad, s_p, deq, psum_bits=6)
    with pytest.raises(ValueError, match="cannot show exact"):
        cim_matmul_adc_free_cuda(a_t, bad, deq)
    assert (cim_conv_cuda.launches, cim_conv_adc_free_cuda.launches,
            cim_matmul_cuda.launches,
            cim_matmul_adc_free_cuda.launches) == before
    good = chip_smoke.varied_planes(torch, g, logical.cpu(), 0.4).cuda()
    assert torch.equal(cim_conv_cuda(a, good, s_p, deq, psum_bits=6, **geo),
                       ref.cim_conv_ref(a, good, s_p, deq, psum_bits=6,
                                        **geo))
    assert torch.equal(cim_matmul_cuda(a_t, good, s_p, deq, psum_bits=6),
                       ref.cim_matmul_ref(a_t, good, s_p, deq, psum_bits=6))


def test_float_launch_captures_after_its_planes_were_checked():
    """The exactness check reads the planes back on the host, once per
    plane tensor: a float-plane conv captured in a CUDA graph after one
    eager launch replays to the eager result; planes never launched
    before refuse the capture."""
    g = torch.Generator().manual_seed(42)
    a, logical, _, occ, s_p, deq = (
        x.cuda() for x in chip_smoke.implicit_adc_conv_operands(
            torch, g, 3, 1, 64, 80, 1, 3, 42, 40, True))
    noisy = chip_smoke.varied_planes(torch, g, logical.cpu(), 0.3).cuda()
    geo = dict(kh=1, kw=3, stride=2, padding="SAME", c_per_array=42,
               psum_bits=4)
    want = cim_conv_cuda(a, noisy, s_p, deq, occ, **geo)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph):
            out = cim_conv_cuda(a, noisy, s_p, deq, occ, **geo)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    fresh = noisy.clone()
    graph2 = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph2):
                cim_conv_cuda(a, fresh, s_p, deq, occ, **geo)
    torch.cuda.synchronize()


@pytest.mark.parametrize("t", [100, 300, 400])
@pytest.mark.parametrize("case", chip_smoke.IMPLICIT_ADC_CONV_CASES[-5:],
                         ids=_adc_case_id)
def test_front_end_convs_on_drifted_planes_bit_exact_with_plain(case, t):
    """The zoo's front-end convs (whisper's 126-row stems, llava's 196-row
    patch embed) on planes drifted as ``drift_tree`` drifts a served conv
    node (phase 12's schedule at t), with the ADC and ADC-free, against
    their plain versions."""
    from repro_torch.core.variation import DriftSchedule, drift_tree
    b, h, w, c_in, kh, kw, stride, padding, cpa, n, uns, pb, quant = case
    g = torch.Generator().manual_seed(sum(case[:5]) + t)
    a, logical, _, occ, s_p, deq = chip_smoke.implicit_adc_conv_operands(
        torch, g, b, h, w, c_in, kh, kw, cpa, n, uns)
    s, kt, rows, _ = logical.shape
    node = {"w_digits": logical.reshape(s, kt, kh, kw, cpa, n)}
    sched = DriftSchedule(**chip_smoke.DRIFT_SCHED)
    drifted = drift_tree({"conv": node}, Sampler(t), sched.at(t))
    planes = drifted["conv"]["w_digits"].reshape(s, kt, rows, n)
    a, planes, occ, s_p, deq = (x.cuda() for x in (a, planes, occ, s_p, deq))
    geo = dict(kh=kh, kw=kw, stride=stride, padding=padding, c_per_array=cpa)
    mq = dict(psum_bits=pb, psum_quant=quant)
    assert torch.equal(cim_conv_cuda(a, planes, s_p, deq, occ, **geo, **mq),
                       ref.cim_conv_ref(a, planes, s_p, deq, **geo, **mq))
    assert torch.equal(cim_conv_adc_free_cuda(a, planes, deq, occ, **geo),
                       ref.cim_conv_adc_free_ref(a, planes, deq, **geo))


def test_sharded_k1_and_k3_on_two_ranks_of_one_card(tmp_path):
    """Column-parallel K1 and K3 on two gloo ranks sharing ``cuda:0``:
    each rank launches the kernel on its own columns, and the gathered
    output equals the single-device kernel's bit for bit, divisible and
    ragged, int8 and nibble planes."""
    import _torch_mesh_ranks as R
    from repro_torch.kernels import _build
    _build.build()            # the ranks load the built libraries
    ranks = R.run_ranks(R.cuda_body, 2, str(tmp_path), timeout_s=300,
                        device="cuda")
    for res in ranks:
        assert len(res) == 8
        for name, ((single, on_full, on_shards), launches) in res.items():
            assert torch.equal(on_full, single), name
            assert torch.equal(on_shards, single), name
            k1, k3 = launches
            # one single-device launch and one per sharded call
            assert (k1, k3) == ((3, 0) if name.startswith("linear")
                                else (0, 3)), (name, launches)


def test_expert_parallel_moe_and_flash_decode_on_two_ranks_of_one_card(
        tmp_path):
    """The expert-parallel MoE (CIM emulate, forward and gradients) and
    flash decode with the bf16 and int8 caches on two gloo ranks sharing
    ``cuda:0``: the ranks' results equal each other bit for bit, the MoE's
    equal the single device's at rtol 1e-5 / atol 1e-6 of each leaf's
    largest magnitude, and flash decode's logits the single device's
    plain decode at 1e-5 (float32 compute) with the same tokens, over a
    cache each rank holds half of in time."""
    import _torch_mesh_ranks as R
    import _torch_parallel_ranks as P
    import numpy as np
    ranks = R.run_ranks(P.cuda_body, 2, str(tmp_path), timeout_s=300,
                        device="cuda")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree] if isinstance(tree, torch.Tensor) else []
    for res in ranks:
        for a, b in zip(leaves(res), leaves(ranks[0])):
            assert torch.equal(a, b)
        single, sharded = res["moe"]
        for a, b in zip(leaves(sharded), leaves(single)):
            tol = 1e-6 * max(1.0, float(b.abs().max()))
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=tol)
        for kv in ("bf16", "int8"):
            (l1, t1, kind1, _), (l2, t2, kind2, block) = res[f"fd_{kv}"]
            assert torch.equal(t1, t2)
            for a, b in zip(l2, l1):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-5)
            assert (kind1, kind2) == ("Tensor", "DTensor")
            assert block[2] == P.FD_MAX_LEN // 2
