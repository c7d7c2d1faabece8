"""Column-parallel CIM dispatch of the port (DESIGN.md §10) on four gloo
ranks on the CPU: the counterparts of ``tests/test_serve_sharded.py``'s
layer cases, each sharded output equal to the single-device output bit
for bit, on the plain path.

The ranks spawn once for the file (``_torch_mesh_ranks.run_ranks``, a
120 s join limit). Every case runs twice under the mesh: on the full
packed planes (each rank pads and takes its columns per call) and on the
artifact placed with ``DeployArtifact.shard`` (divisible nodes hold
their columns as sharded leaves). The cell-variation theta fields are
drawn by the JAX package over the full logical planes and handed to
every rank. The ADC collector's totals over the mesh equal the single
device's counts (``tests/test_obs.py::
test_sharded_deploy_counters_and_bit_exactness``).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
from repro_torch.kernels import ops

WORLD = 4
CASES = R.ops_cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_ops")
    keys = {"linear_22": 7, "linear_nibble": 7, "conv_10": 9}
    np.savez(out / "theta.npz", **{
        tag: np.asarray(jax.random.normal(jax.random.PRNGKey(keys[tag]),
                                          shape), np.float32)
        for tag, shape in R.theta_shapes().items()})
    return R.run_ranks(R.ops_body, WORLD, str(out))


def _equal(a, b):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_equals_single_device(ranks, name):
    kind, kw, _, tag = CASES[name]
    for res in ranks:
        single, on_full, on_shards = res[name]
        _equal(on_full, single)
        _equal(on_shards, single)
    single = ranks[0][name][0]
    n = kw.get("n", kw.get("c_out"))
    assert single.shape[-1] == n
    assert ranks[0][name + "/sharded_leaf"] == (
        "DTensor" if n % WORLD == 0 else "Tensor")
    if tag is not None:      # the noise reached the planes
        assert not torch.equal(single, ranks[0][name + "/clean"])


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_adc_collector_totals_over_the_mesh(ranks, kind):
    for res in ranks:
        got = res[f"adc_{kind}"]
        (y1, s1), (y4, s4) = got["single"], got["sharded"]
        _equal(y4, y1)
        assert s1["conversions"] > 0 and s1["saturated"] > 0
        for k in ("conversions", "saturated", "kernel_invocations",
                  "worst_col_rate"):
            assert s4[k] == s1[k], k


def test_col_shards(ranks):
    assert ranks[0]["col_shards"] == (WORLD, 1, 1)
    assert ops.col_shards(None) == 1
    assert ops.col_shards(object()) == 1


@pytest.mark.parametrize("n,shards,pad", [(22, 4, 2), (24, 4, 0), (5, 3, 1)])
def test_pad_cols(n, shards, pad):
    g = torch.Generator().manual_seed(0)
    d = torch.randint(-3, 4, (2, 3, 8, n), generator=g, dtype=torch.int8)
    s_p = torch.rand(2, 3, n, generator=g) + 0.5
    deq = torch.rand(2, 3, n, generator=g)
    occ = torch.ones(2, 3, n, dtype=torch.uint8)
    d2, s2, q2, o2 = ops.pad_cols(d, s_p, deq, shards, occ)
    assert d2.shape[-1] == n + pad and (n + pad) % shards == 0
    assert torch.equal(d2[..., :n], d) and torch.equal(s2[..., :n], s_p)
    assert torch.equal(q2[..., :n], deq) and torch.equal(o2[..., :n], occ)
    assert not d2[..., n:].any() and not q2[..., n:].any()
    assert not o2[..., n:].any() and bool((s2[..., n:] == 1).all())
    assert ops.pad_cols(d, s_p, deq, shards)[3] is None


def test_at_use_keeps_linear_nodes_placed():
    """``colshard.at_use`` (a block that reads some leaves directly:
    zamba2's Mamba2 and xlstm's layers) gathers those leaves whole and
    keeps every linear node placed, raw (``w``) and packed (``w_digits``),
    for ``apply_linear``'s placed paths: the column-parallel dispatch reads
    a packed node's shards in place, where a gathered node moved its
    whole planes over ``"model"`` in every layer of a decode step. On
    rank 0 of a dry (1, 2) mesh (the fake process group)."""
    from repro_torch.core import colshard
    from repro_torch.launch.mesh import MeshShape, dry_mesh
    with dry_mesh(MeshShape((1, 2), ("data", "model"))) as dm:
        def cols(shape, dtype):
            local = torch.zeros(shape[:-1] + (shape[-1] // 2,), dtype=dtype,
                                device="meta")
            return colshard.placed(local, dm, colshard.placements_of(
                dm, {len(shape) - 1: ("model",)}), shape)
        packed = {"w_digits": cols((2, 1, 8, 8), torch.int8),
                  "w_occ": cols((2, 1, 8), torch.uint8),
                  "s_a": torch.ones(1)}
        raw = {"w": cols((8, 8), torch.float32)}
        tree = {"in_proj": packed, "out_proj": raw,
                "D": cols((8,), torch.float32)}
        colshard.reset_collective_counts()
        got = colshard.at_use(tree)
        assert got["in_proj"] is packed and got["out_proj"] is raw
        assert not colshard.is_col_sharded(got["D"])
        assert tuple(got["D"].shape) == (8,)
        assert colshard.collective.ops["all-gather"] == 1
