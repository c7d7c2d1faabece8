"""The port's CUDA kernel against its plain PyTorch version, on the card.

Skips where there is no CUDA device. Imports no JAX, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The kernel and ``kernels/ref.py`` add the same float32 terms in the same
order with the same roundings, so they must agree bit for bit; within
the port, deploy is bit-identical with emulate on the card as well.
"""
import dataclasses

import pytest
import torch

from repro_torch import api
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.core.nibble import occupancy_map, pack_nibbles, unpack_nibbles
from repro_torch.kernels import ref
from repro_torch.kernels.cim_conv import cim_conv_cuda
from repro_torch.kernels.cim_matmul import cim_matmul_cuda
from repro_torch.models import resnet

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernel runs only on the card")


def _case(seed, *, m, kt, rows, n, s=3, unsigned=False, groups=1):
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
    packed = pack_nibbles(d.reshape(s, kt, groups, rows // groups, n)
                          ).reshape(s, kt, rows // 2, n)
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
    groups = 2 if nibble else 1
    a, d, packed, s_p, deq, occ = _case(n, m=301, kt=2, n=n,
                                        rows=124 if nibble else 126,
                                        unsigned=unsigned, groups=groups)
    before = cim_matmul_cuda.launches
    got = cim_matmul_cuda(a, packed if nibble else d, s_p, deq,
                          occ if sparse else None, psum_bits=psum_bits,
                          psum_quant=psum_quant, nibble_groups=groups)
    torch.cuda.synchronize()
    assert cim_matmul_cuda.launches == before + 1
    if nibble:
        assert torch.equal(unpack_nibbles(packed, groups=groups), d)
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


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    a, d, _, s_p, deq, _ = _case(2, m=8, kt=1, rows=16, n=8)
    with pytest.raises(NotImplementedError):          # variation planes
        cim_matmul_cuda(a, d.float(), s_p, deq, psum_bits=4)
    with pytest.raises(TypeError):                    # float activations
        cim_matmul_cuda(a.float(), d, s_p, deq, psum_bits=4)
    with pytest.raises(ValueError):                   # planes left on the CPU
        cim_matmul_cuda(a, d.cpu(), s_p, deq, psum_bits=4)


def test_resnet_deploy_bit_exact_with_emulate_on_the_card():
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
    y_e, _ = resnet.forward(params, state, x, cfg, train=False)
    packed = api.pack_model(params, cim)
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    before = cim_conv_cuda.launches
    y_d, _ = resnet.forward(packed, state, x, dcfg, train=False)
    assert cim_conv_cuda.launches == before + 20
    assert y_d.is_cuda and torch.isfinite(y_d).all()
    assert torch.equal(y_d, y_e)
