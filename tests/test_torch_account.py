"""The port's accounting (``launch/account.py``) and its collective counts.

- The layer-point solve equals the direct count at a third depth exactly:
  FLOPs, bytes, collective bytes and ops of the reduced llama3 at 6 layers
  from its points at 1 and 2, on one device and as one rank of (2, 2);
  FLOPs and collectives of the reduced moonshot (three points: dense and
  MoE layers) at 5; FLOPs under accumulation (the reference's accum 2
  delta) at 4 microbatches and 3 layers.
- xlstm's sLSTM loop counted at a short length and scaled by T (blocks by
  kind, ``_xlstm_plan``): FLOPs and collectives equal the direct count at
  3 chunks, of 3 blocks for a train step on one device and of 6 for a
  prefill as one rank of (2, 2).
- Whisper's, xlstm's and zamba2's train steps: the bytes' solve equals
  the direct count at a third depth (one unbind per stack leaf); so do a
  decode cell's counts where the caches split over ``"model"`` (the
  reduced deepseek-v3 with flash decode, zamba2).
- ``solve_exact`` solves in rationals.
- Collective bytes by kind under the fake process group equal what rank
  0 of a (2, 2) mesh of gloo ranks on the CPU counts over the same reduced
  step (``tests/_torch_dryrun_ranks.py``): an emulate train step of llama3
  under FSDP and tensor parallelism, moonshot's expert-parallel train
  step, and a flash-decode step of llama3; the train steps' argument
  bytes from the placements equal what the rank holds.
"""
import dataclasses
from fractions import Fraction

import pytest

import _torch_dryrun_ranks as D
import _torch_mesh_ranks as R
from repro_torch.configs.base import SHAPES
from repro_torch.launch.account import account_cell, solve_exact
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import argument_bytes, count_cell, one_device
from repro_torch.launch.mesh import MeshShape

MESH_22 = MeshShape(*D.MESH)


def _shape(kind, seq=32, batch=8):
    return dataclasses.replace(SHAPES[kind], seq_len=seq, global_batch=batch)


def _both(arch, shape, mesh, accum=1, **kw):
    acct = account_cell(arch, shape, mesh, reduced=True, accum=accum,
                        verbose=False, **kw)
    direct = count_cell(arch, shape, mesh, reduced=True, accum=accum, **kw)
    return acct, direct


@pytest.mark.parametrize("mesh", [one_device(), MESH_22], ids=["1", "2x2"])
def test_layer_solve_equals_direct_count_exactly(mesh):
    acct, direct = _both("llama3-8b", _shape("train_4k"), mesh,
                         overrides={"n_layers": 6})
    assert acct["points"] == 2
    assert acct["hlo_flops"] == direct["flops"]
    assert acct["hlo_bytes"] == direct["bytes"]
    assert acct["collectives"] == direct["collectives"]
    assert acct["collective_ops"] == direct["collective_ops"]
    assert acct["flops_by_dtype"] == direct["flops_by_dtype"]


def test_moe_three_point_solve_and_accumulation():
    acct, direct = _both("moonshot-v1-16b-a3b", _shape("train_4k"),
                         MESH_22, overrides={"n_layers": 5})
    assert acct["points"] == 3
    assert acct["hlo_flops"] == direct["flops"]
    assert acct["hlo_bytes"] == direct["bytes"]
    assert acct["collectives"] == direct["collectives"]
    acct, direct = _both("llama3-8b", _shape("train_4k", batch=16), MESH_22,
                         accum=4, overrides={"n_layers": 3})
    assert acct["hlo_flops"] == direct["flops"]


@pytest.mark.parametrize("kind,mesh,n_layers", [
    ("train_4k", one_device(), 3), ("prefill_32k", MESH_22, 6)],
    ids=["train", "prefill-2x2"])
def test_slstm_loop_scaled_by_length(kind, mesh, n_layers):
    """Reduced xlstm (chunk 16, an sLSTM block every 3): the six counts of
    ``_xlstm_plan`` solved for 3 or 6 blocks at 48 tokens equal the direct
    count's FLOPs and collectives."""
    acct, direct = _both("xlstm-1.3b", _shape(kind, seq=48), mesh,
                         overrides={"n_layers": n_layers})
    assert acct["points"] == 6
    assert acct["hlo_flops"] == direct["flops"]
    assert acct["collectives"] == direct["collectives"]


@pytest.mark.parametrize("arch,layers", [
    ("whisper-small", {"enc_layers": 3, "n_layers": 2}),
    ("xlstm-1.3b", {"n_layers": 9}),
    ("zamba2-2.7b", {"n_layers": 6})], ids=["whisper", "xlstm", "zamba2"])
def test_stack_bytes_solve_exactly_at_a_third_depth(arch, layers):
    """Whisper's, xlstm's and zamba2's stacks take their layers through one
    unbind per leaf (``models.transformer._layers``), so a train step's
    backward writes each layer's gradient once and its bytes are affine
    in depth: the solve from the layer points equals the direct count at
    a depth past them (a slice per layer made them quadratic)."""
    acct, direct = _both(arch, _shape("train_4k"), one_device(),
                         overrides=layers)
    assert acct["hlo_bytes"] == direct["bytes"]
    assert acct["hlo_flops"] == direct["flops"]


@pytest.mark.parametrize("arch,overrides", [
    ("deepseek-v3-671b", {"n_layers": 5, "flash_decode": True}),
    ("zamba2-2.7b", {"n_layers": 6})], ids=["mla-flash", "zamba2"])
def test_split_cache_decode_solves_exactly(arch, overrides):
    """A decode cell on (2, 2) whose caches split over ``"model"`` (the
    sequence-parallel MLA decode: each layer's ``wkv_b`` planes gathered,
    three all-reduces; zamba2's SSD heads, ``y`` gathered): the layer
    solve equals the direct count at a depth past its points."""
    acct, direct = _both(arch, _shape("decode_32k"), MESH_22,
                         overrides=overrides)
    assert acct["hlo_flops"] == direct["flops"]
    assert acct["hlo_bytes"] == direct["bytes"]
    assert acct["collectives"] == direct["collectives"]
    assert acct["collective_ops"] == direct["collective_ops"]


def test_solve_exact_in_rationals():
    x = solve_exact([[1, 2], [1, 4]], [10, 16])
    assert x == [Fraction(4), Fraction(3)]
    x = solve_exact([[0, 2, 0], [3, 0, 0], [1, 1, 7]], [1, 1, 1])
    assert x == [Fraction(1, 3), Fraction(1, 2), Fraction(1, 42)]


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ranks")
    return R.run_ranks(D.body, 4, str(out), timeout_s=240)[0]


@pytest.mark.parametrize("name", sorted(D.CASES))
def test_fake_group_collectives_equal_gloo(gloo_counts, name):
    arch, shape, cim, ov = D.CASES[name]
    kw = dict(cim=D.cim_of(cim), overrides=ov, accum=1, reduced=True)
    rec = count_cell(arch, D.shape_of(shape), MESH_22, **kw)
    got = gloo_counts[name]
    assert sum(got["collectives"].values()) > 0
    assert rec["collectives"] == got["collectives"]
    assert rec["collective_ops"] == got["ops"]
    if shape == "train_4k":
        cell = build_cell(arch, D.shape_of(shape), MESH_22, **kw)
        assert argument_bytes(cell) == got["held"]
