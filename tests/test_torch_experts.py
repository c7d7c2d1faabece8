"""The MoE experts path of the port against the JAX package, on the CPU.

``ops.cim_matmul_experts`` runs the CIM experts kernel's plain version on
CPU tensors; it is held against the reference's batched experts kernel
(``cim_matmul_experts_pallas`` in interpret mode) on the case grid of
``tests/test_backends.py:322-349`` and on int4 nibble banks, at the
reference's kernel-vs-oracle tolerance (rtol 1e-5, atol 1e-4): both sum
the same float32 terms in the same (t outer, s inner) order. Within the
port the batched expert dispatch equals the per-expert loop of
``linear`` bit for bit, and ``_pack_bank`` packs byte for byte as the
reference's. With ``counts`` (each expert's filled capacity slots) the
filled rows keep their values and the rows past them take the value of
an all-zero code row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import artifact as jart
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.nibble import pack_nibbles as j_pack_nibbles
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch.api import artifact as tart
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.core.nibble import occupancy_map, pack_nibbles
from repro_torch.kernels import ops as tops
from repro_torch.kernels.cim_matmul import cim_matmul_experts_cuda
from repro_torch.models import layers as L

KERNEL_TOL = dict(rtol=1e-5, atol=1e-4)
CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
           act_bits=8, psum_bits=6, array_rows=32, array_cols=32)


def _mk_experts(e, m, kt, rows, n, s, seed=0):
    """The reference's ``_mk_experts`` (``tests/test_backends.py:322``)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    a = jnp.round(jax.random.normal(ks[0], (e, m, kt, rows)) * 4)
    d = jax.random.randint(ks[1], (e, s, kt, rows, n), -3, 4).astype(jnp.int8)
    s_p = jax.random.uniform(ks[2], (e, s, kt, n), minval=0.5, maxval=20.0)
    deq = jax.random.uniform(ks[3], (e, s, kt, n), minval=0.01, maxval=0.1)
    return a, d, s_p, deq


def _port(a, d, s_p, deq):
    """The same operands for the port: int8 codes and planes."""
    a = torch.from_numpy(np.array(a)).to(torch.int8)
    return (a,) + tuple(torch.from_numpy(np.array(v)) for v in (d, s_p, deq))


@pytest.mark.parametrize("e,m,kt,rows,n,s", [
    (2, 8, 1, 32, 16, 1),
    (4, 16, 2, 32, 24, 2),
    (3, 5, 2, 33, 7, 2),      # awkward, non-aligned
])
@pytest.mark.parametrize("psum_bits,psum_quant", [
    (4, True), (8, True), (1, True), (4, False)])
def test_experts_plain_matches_pallas(e, m, kt, rows, n, s, psum_bits,
                                      psum_quant):
    ops = _mk_experts(e, m, kt, rows, n, s)
    want = jops.cim_matmul_experts(*ops, psum_bits=psum_bits,
                                   psum_quant=psum_quant)
    before = cim_matmul_experts_cuda.launches
    got = tops.cim_matmul_experts(*_port(*ops), psum_bits=psum_bits,
                                  psum_quant=psum_quant)
    assert cim_matmul_experts_cuda.launches == before   # the CPU: no launch
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # the plain version, asked for directly, is the same function
    plain = tops.cim_matmul_experts(*_port(*ops), psum_bits=psum_bits,
                                    psum_quant=psum_quant, use_kernel=False)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("psum_bits", [1, 6])
def test_experts_nibble_banks_match_pallas(psum_bits):
    ops = _mk_experts(3, 8, 2, 32, 16, 2, seed=1)
    d = np.array(ops[1])
    d[1, :, 0] = 0                          # a dead (split, tile) on expert 1
    d[..., 3:6] = 0                         # dead columns on every expert
    ops = (ops[0], jnp.asarray(d)) + ops[2:]
    want = jops.cim_matmul_experts(*ops, psum_bits=psum_bits)
    j_nib = np.asarray(j_pack_nibbles(ops[1]))
    a, d_t, s_p, deq = _port(*ops)
    nib = pack_nibbles(d_t)
    np.testing.assert_array_equal(nib.numpy(), j_nib)
    got = tops.cim_matmul_experts(a, nib, s_p, deq, psum_bits=psum_bits,
                                  occ=occupancy_map(d_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    dense = tops.cim_matmul_experts(a, d_t, s_p, deq, psum_bits=psum_bits)
    assert torch.equal(got, dense)


def _bank(seed, lead, k, n):
    """A random expert bank with column-granularity scales, as numpy."""
    rng = np.random.default_rng(seed)
    t = TCIMConfig(**CIM).tiling(k, n)
    return {"up": (rng.standard_normal(lead + (k, n)) * 0.1).astype(np.float32),
            "up_s_w": rng.uniform(0.01, 0.05, lead + (t.k_tiles, n)
                                  ).astype(np.float32),
            "up_s_p": rng.uniform(2.0, 9.0, lead + (t.n_split, t.k_tiles, n)
                                  ).astype(np.float32),
            "up_s_a": rng.uniform(0.02, 0.08, lead + (1,)).astype(np.float32)}


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_pack_bank_byte_identical(lead, pack_dtype):
    node = _bank(0, lead, 40, 24)
    jcfg = JCIMConfig(**CIM, pack_dtype=pack_dtype).replace(mode="deploy")
    tcfg = TCIMConfig(**CIM, pack_dtype=pack_dtype).replace(mode="deploy")
    want = jax.jit(lambda nd: jart._pack_bank(nd, "up", jcfg, None, None))(
        {k: jnp.asarray(v) for k, v in node.items()})
    pack_lin, _ = tapi.packers_for(tcfg)
    got = tart._pack_bank({k: torch.from_numpy(v) for k, v in node.items()},
                          "up", tcfg, pack_lin)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    if pack_dtype == "int4":
        assert got["up_digits"].dtype == torch.uint8


class _Cfg:
    """The two fields ``_expert_matmul`` reads."""

    def __init__(self, cim):
        self.cim = cim
        self.compute_dtype = "float32"


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_batched_expert_dispatch_equals_per_expert_loop(pack_dtype):
    """The counterpart of ``tests/test_backends.py:361``: the one-launch
    batched path and the per-expert loop of ``linear`` on the same packed
    bank agree bit for bit."""
    node = _bank(1, (3,), 40, 24)
    cim = TCIMConfig(**CIM, pack_dtype=pack_dtype).replace(mode="deploy")
    pack_lin, _ = tapi.packers_for(cim)
    p = tart._pack_bank({k: torch.from_numpy(v) for k, v in node.items()},
                        "up", cim, pack_lin)
    g = torch.Generator().manual_seed(2)
    x = torch.relu(torch.randn((3, 5, 40), generator=g))
    cfg = _Cfg(cim)
    assert L._batched_experts_ok(p, "up", cfg)
    y_batched = L._expert_matmul(p, "up", x, cfg)
    y_loop = L._per_expert_matmul(p, "up", x, cfg)
    assert torch.equal(y_batched, y_loop)
    # the plain version takes the loop and gives the same bits
    ref_cfg = _Cfg(cim.replace(use_kernel=False))
    assert not L._batched_experts_ok(p, "up", ref_cfg)
    assert torch.equal(L._expert_matmul(p, "up", x, ref_cfg), y_batched)


@pytest.mark.parametrize("psum_bits", [1, 4, 6])
@pytest.mark.parametrize("nibble", [False, True])
def test_experts_counts_give_filled_rows_and_zero_rows_past_them(psum_bits,
                                                                 nibble):
    """``counts`` (each expert's filled capacity slots): an empty expert,
    a full one (cap) and ragged ones. Rows below counts[e] are the
    no-counts result bit for bit, and match the reference's batched
    experts kernel; rows at or past it take the value of an all-zero code
    row (the reference on zeroed codes), bit for bit the port on codes
    zeroed there."""
    ops = _mk_experts(4, 8, 2, 32, 16, 2, seed=psum_bits)
    counts = np.array([0, 8, 3, 5], np.int32)
    a, d, s_p, deq = _port(*ops)
    digits = pack_nibbles(d) if nibble else d
    occ = occupancy_map(d) if nibble else None
    kw = dict(psum_bits=psum_bits, occ=occ)
    got = tops.cim_matmul_experts(a, digits, s_p, deq,
                                  counts=torch.from_numpy(counts), **kw)
    full = tops.cim_matmul_experts(a, digits, s_p, deq, **kw)
    want = np.asarray(jops.cim_matmul_experts(*ops, psum_bits=psum_bits))
    zero_rows = np.asarray(jops.cim_matmul_experts(
        jnp.zeros_like(ops[0]), *ops[1:], psum_bits=psum_bits))
    a0 = a.clone()
    for j, c in enumerate(counts):
        assert torch.equal(got[j, :c], full[j, :c])
        np.testing.assert_allclose(got[j, :c].numpy(), want[j, :c],
                                   **KERNEL_TOL)
        np.testing.assert_allclose(got[j, c:].numpy(), zero_rows[j, c:],
                                   **KERNEL_TOL)
        a0[j, c:] = 0
    assert torch.equal(got, tops.cim_matmul_experts(a0, digits, s_p, deq,
                                                    **kw))
    assert not torch.equal(got, full)
