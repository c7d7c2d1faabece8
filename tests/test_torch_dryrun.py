"""The port's dry run (``launch/dryrun.py``) against the reference's
``repro.launch.dryrun`` and its cells, and the meta step paths.

The reference's ``dryrun`` forces 512 host devices when it is imported,
so one subprocess imports it (``_REFERENCE``) and writes, for every cell
of ``all_cells()``, ``param_counts`` and ``model_flops``, and, for the
cells below, each rank's argument bytes: the sum over ``build_cell``'s
argument structs of ``NamedSharding.shard_shape`` times the item size, on
a (2, 2) mesh with ``AxisType.Auto`` axes (ROADMAP fault 20) at reduced
size and on the (16, 16) pod mesh at full size. Nothing is compiled.

The port counts one rank's step on ``meta`` tensors under the fake
process group: every family's train, prefill and decode steps run there,
a reduced prefill's counted FLOPs equal 2 x its MACs from the config's
shapes, a decode cell on (2, 2) counts one rank's rows (half the FLOPs
and cache of (1, 2), no all-gather over ``"data"``), and
``check_overrun`` still raises on a real cache.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, all_cells, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import MeshShape

ROOT = Path(__file__).resolve().parents[1]
MESH_22 = MeshShape((2, 2), ("data", "model"))
MESH_POD = MeshShape((16, 16), ("data", "model"))
#: argument bytes: reduced on (2, 2), full size on (16, 16)
BYTES_22 = ("train_4k", "prefill_32k", "decode_32k")
BYTES_POD = ("train_4k", "decode_32k")
#: the perf experiments' plane packings
PACKS = ("int8", "int4")

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, math, sys, types
    from repro.launch import dryrun        # 512 host devices
    from repro.launch import perf
    import jax
    from jax.sharding import AxisType
    from repro.configs.base import SHAPES
    from repro.configs.registry import all_cells, get_config
    from repro.launch.cells import apply_hints, build_cell
    archs, small, pod, PACKS = json.loads(sys.argv[2])
    out = {"counts": {}, "bytes22": {}, "bytes_pod": {}, "perf_cim": {
        pack: {f.name: str(getattr(c, f.name))
               for f in dataclasses.fields(c)}
        for pack, c in ((p, perf._cim(pack=p)) for p in PACKS)}}
    for arch, shape, ok, _ in all_cells():
        sh = SHAPES[shape]
        cell = types.SimpleNamespace(cfg=apply_hints(get_config(arch), arch),
                                     shape=sh, kind=sh.kind)
        out["counts"][arch + "|" + shape] = [dryrun.param_counts(cell),
                                             dryrun.model_flops(cell)]

    def arg_bytes(cell):
        structs = jax.tree.leaves(cell.arg_structs)
        shards = jax.tree.leaves(cell.in_shardings)
        assert len(structs) == len(shards)
        return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
                   for x, s in zip(structs, shards))

    for key, mesh_shape, shapes, reduced in (
            ("bytes22", (2, 2), small, True),
            ("bytes_pod", (16, 16), pod, False)):
        mesh = jax.make_mesh(mesh_shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        for arch in archs:
            for shape in shapes:
                cell = build_cell(arch, shape, mesh, reduced=reduced)
                out[key][arch + "|" + shape] = arg_bytes(cell)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "reference.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(path),
         json.dumps([sorted(ARCHS), BYTES_22, BYTES_POD, PACKS])],
        env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("pack", PACKS)
def test_cim_config_equals_reference_perf_cim(reference, pack):
    """``cim_config("deploy", pack=)``, which the port's dry run and perf
    experiments share, is the reference perf's ``_cim(pack=)`` field for
    field."""
    c = dryrun.cim_config("deploy", pack=pack)
    got = {f.name: str(getattr(c, f.name)) for f in dataclasses.fields(c)}
    assert got == reference["perf_cim"][pack]


def test_param_counts_and_model_flops_on_every_cell(reference):
    for arch, shape, _, _ in all_cells():
        cell = build_cell(arch, shape, dryrun.one_device())
        want_pc, want_mf = reference["counts"][f"{arch}|{shape}"]
        assert dryrun.param_counts(cell) == want_pc, (arch, shape)
        assert dryrun.model_flops(cell) == want_mf, (arch, shape)


@pytest.mark.parametrize("mesh,key,shapes,reduced", [
    (MESH_22, "bytes22", BYTES_22, True),
    (MESH_POD, "bytes_pod", BYTES_POD, False)], ids=["2x2", "16x16"])
def test_argument_bytes_equal_reference_shard_shapes(reference, mesh, key,
                                                     shapes, reduced):
    for arch in sorted(ARCHS):
        for shape in shapes:
            cell = build_cell(arch, shape, mesh, reduced=reduced)
            assert dryrun.argument_bytes(cell) == \
                reference[key][f"{arch}|{shape}"], (arch, shape)


def _small(kind, seq=32, batch=4):
    return dataclasses.replace(SHAPES[kind], seq_len=seq, global_batch=batch)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_steps_run_for_every_family(arch):
    """Train, prefill and decode steps of every family run on ``meta``
    tensors, on one device and as one rank of (2, 2); the fake group is
    gone after each."""
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        for mesh in (dryrun.one_device(), MESH_22):
            rec = dryrun.count_cell(arch, _small(kind), mesh, reduced=True,
                                    accum=1)
            assert rec["flops"] > 0 and rec["bytes"] > 0, (kind, mesh)
            assert sum(rec["flops_by_dtype"].values()) == rec["flops"]
            assert rec["peak"] >= rec["argument"] > 0
            multi = mesh is MESH_22
            assert (sum(rec["collectives"].values()) > 0) == multi
            assert not dist.is_initialized()


def test_decode_cell_counts_one_ranks_rows():
    """A decode cell on (2, 2) runs each rank on its rows
    (``launch.cells.serve_rows``): the reduced qwen3's FLOPs a rank are
    those on (1, 2) halved (within 2 %), no all-gather runs over
    ``"data"``, and a rank holds, and peaks with, half the cache's rows
    that a (1, 2) rank holds (K/V's time over ``"model"`` on both)."""
    shape = _small("decode_32k", 32, 8)
    meshes = {m: MeshShape((m, 2), ("data", "model")) for m in (1, 2)}
    rec = {m: dryrun.count_cell("qwen3-0.6b", shape, meshes[m],
                                reduced=True) for m in (1, 2)}
    assert abs(rec[2]["flops"] * 2 / rec[1]["flops"] - 1) <= 0.02
    assert rec[2]["collective_axes"]["all-gather"].get("data", 0) == 0
    assert rec[2]["collective_axes"]["all-gather"].get("model", 0) > 0
    with dryrun.rank_cell("qwen3-0.6b", shape, meshes[1],
                          reduced=True) as (_, args):
        cache = dryrun.tree_bytes(args[1])
    assert rec[1]["argument"] - rec[2]["argument"] == cache // 2
    assert rec[2]["peak"] <= rec[1]["peak"] - cache // 2


def test_prefill_flops_equal_two_macs_from_shapes():
    """A reduced llama3 prefill (CIM off, one device): the counted FLOPs
    are 2 x the MACs of its projections, attention and head, from the
    config's widths alone."""
    cfg = get_config("llama3-8b", reduced=True)
    b, t = 2, 24
    rec = dryrun.count_cell("llama3-8b", _small("prefill_32k", t, b),
                            dryrun.one_device(), reduced=True)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kvh, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    proj = d * h * hd + 2 * d * kvh * hd + h * hd * d + 3 * d * ff
    attn = 2 * h * t * hd                      # q k^T and p v, per token
    macs = b * t * (cfg.n_layers * (proj + attn) + d * cfg.vocab)
    assert rec["flops"] == 2 * macs


def test_dry_mesh_is_torn_down_on_error():
    from repro_torch.launch.mesh import dry_mesh
    with pytest.raises(RuntimeError, match="inside"):
        with dry_mesh(MESH_22) as m:
            assert dist.get_world_size() == 4 and m.shape == (2, 2)
            raise RuntimeError("inside")
    assert not dist.is_initialized()


def test_run_cell_record_keeps_reference_keys():
    rec = dryrun.run_cell("qwen3-0.6b", _small("train_4k"), mesh=MESH_22,
                          verbose=False, overrides={"n_layers": 2}, accum=1)
    assert rec["status"] == "ok" and rec["chips"] == 4
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes",
              "collective_ops", "bytes_per_device_argument",
              "bytes_per_device_output", "bytes_per_device_temp",
              "bytes_per_device_alias", "bytes_per_device_peak"):
        assert k in rec["per_device"]
    for k in ("compute_s", "memory_s", "collective_s", "dominant",
              "model_flops_global", "useful_ratio"):
        assert k in rec["roofline"]
    assert rec["roofline"]["fit_bound_gb"] == 80.0
    skip = dryrun.run_cell("llama3-8b", "long_500k", verbose=False)
    assert skip["status"] == "skipped"


def test_check_overrun_still_raises_on_a_real_cache():
    """The meta cache skips the host read; a real CPU cache still raises."""
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import check_overrun
    from repro_torch.nn.module import init_params
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0, device="cpu")
    cache = model.init_cache(cfg, 1, 4, device="cpu")
    tokens = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="overrun"):
        model.decode_step(params, cache, tokens, cfg)
    meta = model.init_cache(cfg, 1, 4, device="meta")
    check_overrun(meta["layers"], tokens.to("meta"))
