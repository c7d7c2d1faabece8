"""LSQ and straight-through gradients of the port against the JAX package.

``repro_torch.core.quantizer``'s ``_LSQ`` and ``_LSQBinary`` autograd
functions are held against ``jax.vjp`` of the reference's
``lsq_fake_quant`` (its ``custom_vjp``s) on the same numpy inputs: bits
1-8, signed and unsigned, scalar, per-column and row-broadcast scales,
with and without ``group_size``, x on the clip edges. The forward must
be equal, dx at rtol 1e-6 / atol 1e-7. The scale's cotangent ds is a sum
over each scale's group, which the two frameworks add in other orders
(the reference's own jitted and eager vjp differ by up to 9.5e-7 on
these inputs, where the terms reach about 8): it is held at rtol 1e-6
and an atol of 1e-7 plus the float32 error bound of the two sums,
2 n eps sum|terms| for n terms (``_sum_bound``). ``split_digits``'s
least-norm STE is held against ``jax.vjp`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitsplit as jbits
from repro.core import quantizer as jq
from repro_torch.core import bitsplit as tbits
from repro_torch.core import quantizer as tq
from repro_torch.kernels import ref as tref

GRAD_TOL = dict(rtol=1e-6, atol=1e-7)
M, N = 16, 12
SCALES = {"scalar": (1,), "column": (1, N), "row": (M, 1)}


def _sum_bound(x, s, dy, bits, signed, group_size):
    """Per scale element, the float32 error bound of two sums of the ds
    terms dy * ds_elem * g in any order: 2 n eps sum|terms|, n terms."""
    qn, qp = jq.qrange(bits, signed)
    n = group_size or x.size // s.size
    g = 1.0 / np.sqrt(n * max(qp, 1))
    v = x / np.maximum(s, 1e-9)
    if bits == 1:
        elem = np.ones_like(v)
    else:
        elem = np.where((v > qn) & (v < qp), np.abs(np.round(v) - v),
                        np.where(v <= qn, abs(qn), abs(qp)))
    terms = np.abs(dy) * elem * g
    while terms.ndim > s.ndim:
        terms = terms.sum(axis=0)
    axes = tuple(i for i, d in enumerate(s.shape) if d == 1)
    count = x.size // s.size
    return 2 * count * 2.0 ** -24 * terms.sum(axis=axes, keepdims=True)


def _inputs(bits, signed, scale_kind):
    """x (M, N) with a quarter of its entries on the clip edges (q_n * s,
    q_p * s, and for sign quantization +-s) and on half-steps, the rest
    spread over twice the range; a positive scale; a cotangent."""
    rng = np.random.RandomState(bits * 7 + signed * 3 + len(scale_kind))
    s = (0.05 + rng.rand(*SCALES[scale_kind])).astype(np.float32)
    qn, qp = jq.qrange(bits, signed)
    sb = np.broadcast_to(s, (M, N))
    x = (rng.randn(M, N) * (qp - qn + 1) * sb).astype(np.float32)
    edges = np.stack([qn * sb, qp * sb, -sb, sb, (qp - 0.5) * sb,
                      (qn + 0.5) * sb]).astype(np.float32)
    pick = rng.randint(0, edges.shape[0], size=(M, N))
    mask = rng.rand(M, N) < 0.25
    x = np.where(mask, np.take_along_axis(edges, pick[None], 0)[0], x)
    dy = rng.randn(M, N).astype(np.float32)
    return x.astype(np.float32), s, dy


@pytest.mark.parametrize("group_size", [None, 7])
@pytest.mark.parametrize("scale_kind", sorted(SCALES))
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits", range(1, 9))
def test_lsq_gradients_match_reference(bits, signed, scale_kind, group_size):
    x, s, dy = _inputs(bits, signed, scale_kind)

    @jax.jit
    def ref(x_, s_, dy_):
        y, vjp = jax.vjp(lambda a, b: jq.lsq_fake_quant(
            a, b, bits, signed=signed, group_size=group_size), x_, s_)
        return (y,) + vjp(dy_)

    y_j, dx_j, ds_j = (np.asarray(v) for v in ref(x, s, dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    y = tq.lsq_fake_quant(xt, st, bits, signed=signed, group_size=group_size)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), y_j)
    np.testing.assert_allclose(xt.grad.numpy(), dx_j, **GRAD_TOL)
    assert st.grad.shape == st.shape
    bound = _sum_bound(x, s, dy, bits, signed, group_size)
    assert np.all(np.abs(st.grad.numpy() - ds_j)
                  <= GRAD_TOL["atol"] + bound + GRAD_TOL["rtol"]
                  * np.abs(ds_j))


@pytest.mark.parametrize("bits,signed", [(1, True), (3, False), (4, True)])
def test_lsq_integer_gradients_match_reference(bits, signed):
    x, s, dy = _inputs(bits, signed, "column")

    @jax.jit
    def ref(x_, s_, dy_):
        y, vjp = jax.vjp(lambda a, b: jq.lsq_integer(
            a, b, bits, signed=signed, group_size=5), x_, s_)
        return (y,) + vjp(dy_)

    y_j, dx_j, ds_j = (np.asarray(v) for v in ref(x, s, dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    y = tq.lsq_integer(xt, st, bits, signed=signed, group_size=5)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(y.detach().numpy(), y_j)
    np.testing.assert_allclose(xt.grad.numpy(), dx_j, **GRAD_TOL)
    # lsq_integer's ds adds -y / s^2 to lsq_fake_quant's, summed alike
    bound = _sum_bound(x, s, dy, bits, signed, 5) + _sum_bound(
        x, s, dy * np.abs(y_j) / s, 1, True, 1)
    assert np.all(np.abs(st.grad.numpy() - ds_j)
                  <= GRAD_TOL["atol"] + bound + GRAD_TOL["rtol"]
                  * np.abs(ds_j))


def test_scale_gradient_is_not_masked_by_the_clamp():
    """s below 1e-9 is clamped in the forward, yet its gradient flows, as
    the reference's custom_vjp returns it."""
    x = np.array([[0.5, -2.0, 3e-9]], np.float32)
    s = np.array([1e-12], np.float32)
    dy = np.ones_like(x)
    _, vjp = jax.vjp(lambda a, b: jq.lsq_fake_quant(a, b, 4), x, s)
    ds_j = np.asarray(vjp(dy)[1])
    st = torch.from_numpy(s).requires_grad_(True)
    tq.lsq_fake_quant(torch.from_numpy(x), st, 4).backward(
        torch.from_numpy(dy))
    assert float(ds_j[0]) != 0.0
    np.testing.assert_allclose(st.grad.numpy(), ds_j, **GRAD_TOL)


def test_lsq_fake_quant_ref_is_the_forward():
    x, s, _ = _inputs(4, True, "column")
    got = tref.lsq_fake_quant_ref(torch.from_numpy(x), torch.from_numpy(s),
                                  -8.0, 7.0)
    np.testing.assert_array_equal(
        got.numpy(), tq.lsq_fake_quant(torch.from_numpy(x),
                                       torch.from_numpy(s), 4).numpy())


def test_round_ste():
    x = torch.tensor([-1.5, -0.5, 0.2, 0.5, 1.5, 2.7], requires_grad=True)
    y = tq.round_ste(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.round(x.detach().numpy()))
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jq.round_ste(jnp.asarray(
            x.detach().numpy()))))
    y.backward(torch.arange(6, dtype=torch.float32))
    np.testing.assert_array_equal(x.grad.numpy(), np.arange(6))


@pytest.mark.parametrize("wb,cb", [(1, 1), (3, 1), (4, 2), (6, 2), (8, 3),
                                   (8, 8)])
def test_split_digits_gradient_matches_reference_exactly(wb, cb):
    rng = np.random.RandomState(wb * 10 + cb)
    qn, qp = jq.qrange(wb, True)
    w = rng.randint(qn, qp + 1, size=(9, 5)).astype(np.float32)
    s_count = 1 if wb == 1 else jbits.split_digits(
        jnp.asarray(w), wb, cb).shape[0]
    g = rng.randn(s_count, 9, 5).astype(np.float32)
    d_j, vjp = jax.vjp(lambda a: jbits.split_digits(a, wb, cb), w)
    (dw_j,) = vjp(g)
    wt = torch.from_numpy(w).requires_grad_(True)
    d = tbits.split_digits(wt, wb, cb)
    d.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(d.detach().numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(dw_j))


@pytest.mark.parametrize("wb,cb", [(3, 1), (4, 2), (8, 3)])
def test_split_digits_ste_recombines_to_the_identity(wb, cb):
    """recombine(grad) == grad: the digits' gradients, weighted by place
    value, add back to the weight's."""
    w = torch.arange(-(2 ** (wb - 1)), 2 ** (wb - 1), dtype=torch.float32)
    w.requires_grad_(True)
    tbits.recombine(tbits.split_digits(w, wb, cb), wb, cb).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), np.ones(w.shape), rtol=1e-6)
