"""Exactness of the float-digit kernel's float64 partial sums, on the CPU.

The float-digit kernel (``csrc/cim_matmul.cu``) runs its MACs on the FP64
tensor cores, whose m16n8k16 MMA may add its sixteen products and the
accumulator in any order. It equals its plain version (a float64 einsum,
``ref._psum``) bit for bit only where each tile's float64 partial sum is
exact. These tests draw planes carrying cell variation (``d *
exp(sigma * theta)``, sigma 0.1-0.4, theta from numpy) on the paper's
ResNet-20 ranges (S = 3, 1-bit cells, 3-bit unsigned codes, rows 126 and
128) and on the grids the card checks (``chip_smoke.py``'s implicit-conv,
matmul and conv cases, which ``tests/test_torch_cuda.py`` shares), and
for every (row, split, tile, column):
- sum the products in float64 in row order and in a k16-chunked,
  fragment-wise order like the MMA's (a pairwise tree over each chunk of
  16 rows, added to the running sum), and compare both with the exact sum
  (integers after scaling each plane by its least digit exponent): all
  three are equal;
- bound the sum of the products' magnitudes below 2^53 units of the
  plane's least digit bit, so every partial sum in any order is exact.
The same holds on the serving launcher's grid, where drift makes the
planes float32 on every drifted linear (the float-digit matmul's path):
8-bit codes, 4-bit weights on 2-bit cells (S = 2), rows 128, k_tiles 16
and 88, under the drift factors of ``tests/test_drift.py``'s schedule at
t up to 400 and of column-only drift at sigma_col 0.4.
The plain float-plane conv is also held against the JAX package's Pallas
conv (interpret mode), theta drawn in JAX and passed in.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import variation as jvar
from repro.kernels.cim_conv import cim_conv_pallas
from repro_torch.core.bitsplit import split_digits
from repro_torch.core.variation import (DriftSchedule, Sampler, drift_tree,
                                        perturb_digits)
from repro_torch.kernels import ref
from repro_torch.kernels.cim_matmul import EXACT_BITS, float_sums_exact

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SIGMAS = (0.1, 0.2, 0.3, 0.4)


def _check_exact(a_t, digits):
    """a_t (M, kt, rows) integer codes, digits (S, kt, rows, N) float32:
    the row-order and the k16-chunked float64 sums of every tile equal the
    exact sum, and the magnitudes' sum stays below 2^53 units."""
    a = a_t.numpy().astype(np.int64)
    d = digits.numpy().astype(np.float64)
    for s in range(d.shape[0]):
        for t in range(d.shape[1]):
            plane = d[s, t]                               # (rows, N)
            nz = plane[plane != 0]
            if nz.size == 0:
                continue
            # every float32 digit is an integer multiple of 2^(e - 24)
            shift = 24 - int(np.frexp(np.abs(nz))[1].min())
            d_int = np.ldexp(plane, shift)
            assert np.array_equal(d_int, np.round(d_int))
            d_int = d_int.astype(np.int64)
            a_tile = a[:, t]                              # (M, rows)
            bound = np.abs(a_tile) @ np.abs(d_int)
            assert int(bound.max()) < 2 ** 53
            exact = np.ldexp((a_tile @ d_int).astype(np.float64), -shift)
            prods = a_tile[:, :, None].astype(np.float64) * plane[None]
            rows = plane.shape[0]
            row_order = np.zeros(exact.shape)
            for r in range(rows):
                row_order = row_order + prods[:, r]
            chunked = np.zeros(exact.shape)
            pad = np.concatenate([prods, np.zeros(
                (prods.shape[0], (-rows) % 16, prods.shape[2]))], axis=1)
            for k0 in range(0, pad.shape[1], 16):
                tree = pad[:, k0:k0 + 16]
                while tree.shape[1] > 1:
                    tree = tree[:, 0::2] + tree[:, 1::2]
                chunked = chunked + tree[:, 0]
            assert np.array_equal(row_order, exact)
            assert np.array_equal(chunked, exact)
            # the plain version's float64 einsum gives the same sum
            einsum = torch.einsum("mr,rn->mn",
                                  torch.from_numpy(a_tile).double(),
                                  torch.from_numpy(plane)).numpy()
            assert np.array_equal(einsum, exact)


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("rows", [126, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paper_grid_tile_sums_are_exact_in_any_order(sigma, rows, seed):
    """ResNet-20's column (benchmarks/common.py): 3-bit weights on 1-bit
    cells (S = 3 signed digits in {-1, 0, 1}), 3-bit unsigned codes."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 8, (96, 2, rows)).astype(np.uint8))
    d = torch.from_numpy(rng.integers(-1, 2, (3, 2, rows, 40))
                         .astype(np.int8))
    theta = rng.standard_normal(d.shape).astype(np.float32)
    _check_exact(a, perturb_digits(d, theta, sigma))


#: the drift of tests/test_drift.py::_sched at t 100 and 400, and
#: column-only drift at sigma_col = 0.4
SERVING_DRIFTS = {
    "sched_t100": DriftSchedule(read_sigma=0.02, cell_rate=2e-4,
                                col_rate=1e-3).at(100),
    "sched_t400": DriftSchedule(read_sigma=0.02, cell_rate=2e-4,
                                col_rate=1e-3).at(400),
    "col_t400": DriftSchedule(col_rate=1e-3).at(400),
}


@pytest.mark.parametrize("drift", sorted(SERVING_DRIFTS))
@pytest.mark.parametrize("k_tiles", [16, 88])
@pytest.mark.parametrize("unsigned", [True, False])
def test_serving_grid_tile_sums_are_exact_in_any_order(drift, k_tiles,
                                                       unsigned):
    """The serving launcher's CIM config (chip_smoke.launcher_cim): 4-bit
    weights split onto 2-bit cells (S = 2), 8-bit codes, 128-row arrays,
    k_tiles 16 (d_model 2048) and 88 (the dense MLP's down projection,
    d_ff 11264), the planes drifted as ``drift_tree`` drifts a served
    node."""
    rng = np.random.default_rng(k_tiles + len(drift) + unsigned)
    rows, n = 128, 32
    lo, hi = (0, 256) if unsigned else (-128, 128)
    a = torch.from_numpy(rng.integers(lo, hi, (16, k_tiles, rows)).astype(
        np.uint8 if unsigned else np.int8))
    w = torch.from_numpy(rng.integers(-8, 8, (k_tiles * rows, n)).astype(
        np.float32))
    digits = split_digits(w, 4, 2).reshape(2, k_tiles, rows, n)
    assert digits.abs().max() <= 3
    node = {"w_digits": digits.to(torch.int8)}
    drifted = drift_tree({"wd": node}, Sampler(k_tiles),
                         SERVING_DRIFTS[drift])["wd"]["w_digits"]
    assert drifted.dtype == torch.float32
    _check_exact(a, drifted)


#: the zoo's front ends in chip_smoke's conv grid (whisper's 126-row stems,
#: llava's 196-row patch embed): their tile sums are summed on the first
#: FRONT_M output pixels and FRONT_N columns (a front end's grid case has
#: up to 6,000 pixels and 1,024 columns; the ranges set the bits a sum
#: needs, and the bound is checked on every column)
FRONT_ENDS = chip_smoke.IMPLICIT_ADC_CONV_CASES[-5:]
FRONT_M, FRONT_N = 128, 96


@pytest.mark.parametrize("case", chip_smoke.FLOAT_CONV_CASES,
                         ids=lambda c: "x".join(map(str, c[:5])))
def test_card_implicit_grid_tile_sums_are_exact_in_any_order(case):
    """The float-plane implicit convs of chip_smoke.py (phase 3b) and
    tests/test_torch_cuda.py: 8-bit codes, digits -8..7, every sigma; the
    launch's bound (``float_sums_exact``) holds on every column."""
    b, h, w, c_in, kh, kw, stride, padding, cpa, n, uns, _, _ = case
    g = torch.Generator().manual_seed(sum(case[:5]) + stride + n)
    a, logical, _, _, _, _ = chip_smoke.implicit_adc_conv_operands(
        torch, g, b, h, w, c_in, kh, kw, cpa, n, uns)
    a_t = ref.extract_conv_patches(a, kh, kw, stride, padding,
                                   logical.shape[1], cpa)
    a_t = a_t.reshape(-1, logical.shape[1], logical.shape[2])
    for sigma in SIGMAS:
        planes = chip_smoke.varied_planes(torch, g, logical, sigma)
        assert bool(float_sums_exact(planes, uns).all())
        if case in FRONT_ENDS:
            _check_exact(a_t[:FRONT_M], planes[..., :FRONT_N].contiguous())
        else:
            _check_exact(a_t, planes)


@pytest.mark.parametrize("case", chip_smoke.MATMUL_CASES,
                         ids=lambda c: "x".join(map(str, c[:4])))
def test_card_matmul_grid_tile_sums_are_exact_in_any_order(case):
    """chip_smoke.py's float-plane matmul cases (phase 3b, sigma 0.3 there;
    every sigma here), on their first 64 rows of codes: the ranges, not
    the row count, set the bits a sum needs."""
    m, kt, rows, n, uns, groups, _, _, _ = case
    g = torch.Generator().manual_seed(m)
    a, d, *_ = chip_smoke._matmul_operands(torch, g, min(m, 64), kt, rows, n,
                                           uns, groups)
    for sigma in SIGMAS:
        _check_exact(a, chip_smoke.varied_planes(torch, g, d, sigma))


@pytest.mark.parametrize("case", chip_smoke.CONV_CASES,
                         ids=lambda c: "x".join(map(str, c[:3])))
def test_card_conv_grid_tile_sums_are_exact_in_any_order(case):
    kh, stride, padding, *_ = case
    g = torch.Generator().manual_seed(kh * 10 + stride)
    a, _, logical, *_, cpa = chip_smoke._conv_operands(torch, g, kh, False)
    a_t = ref.extract_conv_patches(a, kh, kh, stride, padding,
                                   logical.shape[1], cpa)
    a_t = a_t.reshape(-1, logical.shape[1], logical.shape[2])
    for sigma in SIGMAS:
        _check_exact(a_t, chip_smoke.varied_planes(torch, g, logical, sigma))


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("kh,stride,psum_bits", [(3, 1, 4), (3, 2, 1),
                                                 (1, 1, 6)])
def test_plain_float_conv_matches_pallas_conv(sigma, kh, stride, psum_bits):
    """``ref.cim_conv_ref`` on float planes against the reference's
    ``cim_conv_pallas`` (interpret mode) on the same clean planes and the
    same theta: the reference draws theta from its key over the logical
    planes, and the port gets that field as numpy. The paper's ranges
    (3-bit unsigned codes, S = 3 digits in {-1, 0, 1}), 14 channels per
    array at 3x3, 128 at 1x1."""
    rng = np.random.default_rng(int(10 * sigma) + kh + stride)
    cpa = 14 if kh == 3 else 128
    c_in, c_out = 20, 12
    kt = -(-c_in // cpa)
    a = rng.integers(0, 8, (2, 7, 6, c_in)).astype(np.int8)
    d6 = rng.integers(-1, 2, (3, kt, kh, kh, cpa, c_out)).astype(np.int8)
    d6[:, -1, :, :, c_in - (kt - 1) * cpa:] = 0      # padded channel slots
    logical = d6.reshape(3, kt, kh * kh * cpa, c_out)
    s_p = (0.5 + rng.random((3, kt, c_out)) * 20).astype(np.float32)
    deq = (rng.standard_normal((3, kt, c_out)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(int(100 * sigma) + kh)
    geo = dict(kh=kh, kw=kh, stride=stride, padding="SAME", c_per_array=cpa,
               psum_bits=psum_bits)
    theta = np.asarray(jax.jit(lambda k: jax.random.normal(
        k, logical.shape, jnp.float32))(key))
    # the reference perturbs with the same field
    np.testing.assert_array_equal(
        np.asarray(jvar.perturb_digits(jnp.asarray(logical), key, sigma)),
        np.asarray(jnp.asarray(logical, jnp.float32)
                   * jnp.exp(jnp.float32(sigma) * jnp.asarray(theta))))
    want = np.asarray(cim_conv_pallas(
        jnp.asarray(a), jnp.asarray(logical), jnp.asarray(s_p),
        jnp.asarray(deq), key, sigma, interpret=True, **geo))
    noisy = perturb_digits(torch.from_numpy(logical), theta, sigma)
    got = ref.cim_conv_ref(torch.from_numpy(a), noisy, torch.from_numpy(s_p),
                           torch.from_numpy(deq), **geo)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


#: the zoo's front-end convs: (kh, kw, C_in, c_per_array) at the serving
#: launcher's 128-row arrays: whisper's 1x3 stems (tiles of 126 rows, kt 2
#: and 19 at C_in 80 and 768) and llava's 14x14 patch embed on 3 channels
#: (tiles of 196 rows, kt 3)
FRONT_END_CONVS = {"whisper_conv1": (1, 3, 80, 42),
                   "whisper_conv2": (1, 3, 768, 42),
                   "llava_patch": (14, 14, 3, 1)}


@pytest.mark.parametrize("drift", sorted(SERVING_DRIFTS))
@pytest.mark.parametrize("conv", sorted(FRONT_END_CONVS))
@pytest.mark.parametrize("unsigned", [True, False])
def test_front_end_drifted_tile_sums_are_exact_in_any_order(drift, conv,
                                                            unsigned):
    """The serving launcher's CIM config (4-bit weights on 2-bit cells, S =
    2, 8-bit codes) on the front ends' conv planes, drifted as
    ``drift_tree`` drifts a served 6-D conv node (its column field one
    factor per (split, tile, column)): the bound holds on every column,
    and the tile sums of 126 and 196 rows are exact in any order."""
    kh, kw, c_in, cpa = FRONT_END_CONVS[conv]
    kt, rows, n = -(-c_in // cpa), kh * kw * cpa, 32
    rng = np.random.default_rng(kt + rows + len(drift) + unsigned)
    w = rng.integers(-8, 8, (kt * rows, n)).astype(np.float32)
    d6 = split_digits(torch.from_numpy(w), 4, 2).reshape(2, kt, kh, kw, cpa,
                                                         n)
    node = {"w_digits": d6.to(torch.int8)}
    drifted = drift_tree({"conv": node}, Sampler(rows),
                         SERVING_DRIFTS[drift])["conv"]["w_digits"]
    assert drifted.dtype == torch.float32 and drifted.ndim == 6
    planes = drifted.reshape(2, kt, rows, n)
    assert bool(float_sums_exact(planes, unsigned).all())
    lo, hi = (0, 256) if unsigned else (-128, 128)
    a = torch.from_numpy(rng.integers(lo, hi, (64, kt, rows)).astype(
        np.uint8 if unsigned else np.int8))
    _check_exact(a, planes)


def test_the_bound_refuses_what_it_cannot_show():
    """``float_sums_exact`` per tile column: a column spanning 2^60
    between its largest and least nonzero digit fails, and there the
    float64 sum in row order really is inexact; a column at the bound
    (rows x 255 x hi <= 2^29 x lo, 196 rows) passes and sums exactly; a
    dead column passes; a non-finite digit fails; int8 codes (bound 128)
    allow a wider span than uint8 ones (255)."""
    rows = 196
    planes = torch.ones((1, 1, rows, 5), dtype=torch.float32)
    planes[0, 0, 0, 0] = 2.0 ** 60
    at_bound = 2.0 ** EXACT_BITS // (rows * 255)
    planes[0, 0, 0, 1] = at_bound
    planes[0, 0, :, 2] = 0.0
    planes[0, 0, 5, 3] = float("inf")
    planes[0, 0, 0, 4] = 2.0 ** EXACT_BITS // (rows * 128)
    ok = float_sums_exact(planes, True)[0, 0]
    assert ok.tolist() == [False, True, True, False, False]
    assert float_sums_exact(planes, False)[0, 0].tolist() == [
        False, True, True, False, True]
    codes = np.full(rows, 255, np.int64)
    col = planes[0, 0, :, 0].double().numpy()
    row_order = 0.0
    for r in range(rows):
        row_order += float(codes[r] * col[r])
    exact = 255 * 2 ** 60 + 255 * (rows - 1)
    assert int(row_order) != exact
    _check_exact(torch.from_numpy(codes.astype(np.uint8))[None, None],
                 planes[:, :, :, 1:2].contiguous())


def test_whole_nodes_checked_once_cover_their_layers(monkeypatch):
    """``check_float_planes`` (``drift_tree`` calls it on the card) checks a
    realization's whole nodes in one pass: a launch on a stacked node's
    layer or on a conv node's 4-D view then reads nothing back; a node it
    cannot show is not kept, and its launch's check raises; a write to
    the planes makes them new."""
    from repro_torch.kernels import cim_matmul as km
    seen = []
    orig = km.float_sums_exact
    monkeypatch.setattr(km, "float_sums_exact", lambda d, u: (
        seen.append(tuple(d.shape)), orig(d, u))[1])
    rng = np.random.default_rng(5)
    stacked = perturb_digits(torch.from_numpy(rng.integers(
        -3, 4, (3, 2, 2, 16, 8)).astype(np.int8)), torch.from_numpy(
        rng.standard_normal((3, 2, 2, 16, 8)).astype(np.float32)), 0.4)
    conv = perturb_digits(torch.from_numpy(rng.integers(
        -3, 4, (2, 2, 3, 3, 14, 8)).astype(np.int8)), torch.from_numpy(
        rng.standard_normal((2, 2, 3, 3, 14, 8)).astype(np.float32)), 0.4)
    bad = torch.ones((2, 2, 16, 8))
    bad[0, 0, 0, 0] = 2.0 ** 40
    km.check_float_planes([stacked, conv, bad])
    assert len(seen) == 3
    for i in range(3):
        km.check_float_exact("k1", stacked[i], i % 2 == 0)
    km.check_float_exact("k3", conv.reshape(2, 2, 126, 8), True)
    assert len(seen) == 3
    with pytest.raises(ValueError, match=r"planes \(2, 2, 16, 8\)"):
        km.check_float_exact("k1", bad, True)
    stacked[0, 0, 0, 0, 0] += 1.0                  # written: checked anew
    km.check_float_exact("k1", stacked[0], True)
    assert len(seen) == 5
