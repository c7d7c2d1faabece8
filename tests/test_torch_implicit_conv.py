"""The implicit-GEMM conv's index arithmetic, on the CPU.

The ADC-free conv kernel (``csrc/cim_adc_free_mma.cu``) gathers its
stretched-kernel patch rows itself: output row m -> (b, ho, wo), logical
row r of array tile t -> tap (dh, dw) and channel c, pads by XLA's rule.
``ref.implicit_conv_rows`` is that index map in plain torch, and
``ref.conv_geometry`` gives the kernel its launch arguments. Both are held
here, exactly, against the port's ``extract_conv_patches`` and the JAX
package's, on integer codes made with numpy from a seed, and the pads
against ``jax.lax.padtype_to_pads``. The kernel itself is held against its
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

# (kh, c_per_array): 3x3 taps of 14 channels (rows 126) as the paper's
# CIFAR-10 arrays hold them, 1x1 projections of 128 channels, 1x1 of 14
KERNEL_TILES = [(3, 14), (1, 128), (1, 14)]


def _codes(seed, b, h, w, c):
    return np.random.RandomState(seed).randint(
        -128, 128, size=(b, h, w, c)).astype(np.int8)


@pytest.mark.parametrize("h,w", [(7, 9), (8, 8), (8, 10), (9, 7)])
@pytest.mark.parametrize("kh", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_geometry_pads_match_xla(h, w, kh, stride, padding):
    geo = ref.conv_geometry((2, h, w, 5), kh, kh, stride, padding, 1, 14)
    want = jax.lax.padtype_to_pads((h, w), (kh, kh), (stride, stride),
                                   padding)
    assert geo.pads == tuple((int(lo), int(hi)) for lo, hi in want)
    patches = ref.extract_conv_patches(torch.zeros(2, h, w, 5), kh, kh,
                                       stride, padding, 1, 14)
    assert (geo.batch, geo.ho, geo.wo) == tuple(patches.shape[:3])
    assert geo.m == 2 * geo.ho * geo.wo and geo.rows == kh * kh * 14
    if padding == "SAME" and stride == 2 and kh == 3 and h % 2 == 0:
        assert geo.pads[0] == (0, 1)       # not torch's symmetric padding=1


@pytest.mark.parametrize("kh,cpa", KERNEL_TILES)
@pytest.mark.parametrize("c_in", [3, 14, 15, 16, 29])
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (2, "VALID")])
@pytest.mark.parametrize("h,w", [(7, 9), (8, 8)])
def test_implicit_rows_equal_both_patch_gathers(kh, cpa, c_in, stride,
                                                padding, h, w):
    a = _codes(c_in * 10 + kh, 3, h, w, c_in)
    kt = -(-c_in // cpa)
    geo = ref.conv_geometry(a.shape, kh, kh, stride, padding, kt, cpa)
    want = np.asarray(jref.extract_conv_patches(
        jnp.asarray(a), kh, kh, stride, padding, kt, cpa)).reshape(
            geo.m, kt, geo.rows)
    mine = ref.extract_conv_patches(torch.from_numpy(a), kh, kh, stride,
                                    padding, kt, cpa)
    np.testing.assert_array_equal(mine.reshape(geo.m, kt, -1).numpy(), want)
    m_idx = torch.arange(geo.m)
    for t in range(kt):
        got = ref.implicit_conv_rows(torch.from_numpy(a), m_idx, t, kh=kh,
                                     kw=kh, stride=stride, pads=geo.pads,
                                     c_per_array=cpa)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want[:, t])


@pytest.mark.parametrize("b,h,w,c_in,kh,stride,padding,cpa", [
    (4, 5, 5, 16, 3, 1, "SAME", 14),      # 25 rows an image
    (5, 8, 8, 29, 3, 2, "SAME", 14),      # 16 rows an image
    (3, 9, 7, 15, 3, 2, "VALID", 14),     # 12 rows an image
    (6, 4, 6, 32, 1, 2, "SAME", 128),
    (2, 3, 3, 3, 3, 1, "SAME", 14),
    (7, 6, 5, 64, 3, 2, "SAME", 14)])
def test_implicit_rows_across_image_edges(b, h, w, c_in, kh, stride, padding,
                                          cpa):
    """Row blocks that straddle two images (and run past M) gather the rows
    of each image, and zeros past the last output row."""
    a = _codes(b * h * w, b, h, w, c_in)
    kt = -(-c_in // cpa)
    geo = ref.conv_geometry(a.shape, kh, kh, stride, padding, kt, cpa)
    want = np.asarray(jref.extract_conv_patches(
        jnp.asarray(a), kh, kh, stride, padding, kt, cpa)).reshape(
            geo.m, kt, geo.rows)
    per_image = geo.ho * geo.wo
    edges = [e for img in range(1, b) for e in range(img * per_image - 3,
                                                     img * per_image + 3)]
    m_idx = torch.tensor(edges + [geo.m - 1, geo.m, geo.m + 5])
    for t in range(kt):
        got = ref.implicit_conv_rows(torch.from_numpy(a), m_idx, t, kh=kh,
                                     kw=kh, stride=stride, pads=geo.pads,
                                     c_per_array=cpa).numpy()
        np.testing.assert_array_equal(got[:-2], want[m_idx[:-2].numpy(), t])
        assert not got[-2:].any()


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_implicit_rows_keep_the_code_dtype(dtype):
    rng = np.random.RandomState(3)
    lo, hi = (-128, 128) if dtype == np.int8 else (0, 256)
    a = rng.randint(lo, hi, size=(2, 6, 6, 20)).astype(dtype)
    geo = ref.conv_geometry(a.shape, 3, 3, 2, "SAME", 2, 14)
    patches = ref.extract_conv_patches(torch.from_numpy(a), 3, 3, 2, "SAME",
                                       2, 14).reshape(geo.m, 2, -1)
    for t, m_idx in itertools.product(range(2), ([0, 5, 17], [8, 9])):
        got = ref.implicit_conv_rows(torch.from_numpy(a), m_idx, t, kh=3,
                                     kw=3, stride=2, pads=geo.pads,
                                     c_per_array=14)
        assert got.dtype == patches.dtype
        assert torch.equal(got, patches[m_idx, t])


def test_patch_gathers_on_the_cpu_are_not_counted():
    before = ref.extract_conv_patches.cuda_gathers
    ref.extract_conv_patches(torch.zeros(1, 4, 4, 3, dtype=torch.int8), 3, 3,
                             1, "SAME", 1, 14)
    assert ref.extract_conv_patches.cuda_gathers == before
