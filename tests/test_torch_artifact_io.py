"""Checkpoints and ``DeployArtifact``s on disk, across the two packages, on
the CPU at a small size (following ``tests/test_checkpoint.py`` and
``tests/test_artifact_migration.py``).

Both packages write the same format (``manifest.json`` with raw-byte
``.npy`` leaves and a logical dtype string; ``artifact.json`` last), so
a tree saved by one loads in the other with bit-equal leaves, and the
same tree saved by both gives the same files byte for byte. Dense int4
leaves are int8 in [-8, 7] in the port and ``ml_dtypes.int4`` in the
reference; bfloat16 keeps its bits. The port decodes both without
``ml_dtypes``.

Artifacts of a linear layer, a conv layer, the reduced ResNet-20 (widths
4/8/16 at 8x8, 64-row arrays: dense int4 3x3 planes, nibble 1x1 planes)
and the reduced moonshot-v1-16b-a3b, int8 and int4, go both ways: the
loaded leaves equal the other package's own pack, and the forwards of
the loaded artifacts (the port's plain path on the CPU, the reference's
deploy backend) agree at rtol 1e-5 / atol 1e-4.
"""
import dataclasses
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.core.nibble import is_nibble_packed, unpack_nibbles
from repro.models import resnet as jres
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro_torch import api as tapi
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.registry import get_config
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.core.nibble import unpack_nibbles as t_unpack_nibbles
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import resnet as tres
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import engine_from_artifact

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
FWD_TOL = dict(rtol=1e-5, atol=1e-4)
# the paper's CIFAR-10 column on 64-row arrays (ResNet), the zoo-parity
# config (moonshot), a 4-bit-weight config for the single layers
RESNET_CIM = dict(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                  act_bits=3, psum_bits=4, array_rows=64, array_cols=64,
                  act_signed=False)
MOE_CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
               act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
LAYER_CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                 act_bits=6, psum_bits=4, array_rows=32, array_cols=32)
ARCH = "moonshot-v1-16b-a3b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(a):
    """A numpy view whose equality is bit equality (bfloat16 as int16)."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_leaves_equal(got, want, path=""):
    """Port tree == reference tree leaf for leaf in dtype and bits (the
    reference's dense int4 as the port's int8)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_leaves_equal(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_leaves_equal(g, w, f"{path}/{i}")
        return
    want = np.asarray(want)
    if want.dtype.name == "int4":
        want = want.astype(np.int8)
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, path
        got, want = got.view(torch.int16), want.view(np.int16)
    got = got.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def _assert_jax_trees_equal(got, want):
    """Two reference trees equal in structure, dtype and bits."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _assert_same_files(a, b):
    """Two directories hold the same files with the same bytes."""
    names_a = sorted(str(p.relative_to(a)) for p in Path(a).rglob("*"))
    names_b = sorted(str(p.relative_to(b)) for p in Path(b).rglob("*"))
    assert names_a == names_b
    for n in names_a:
        if (Path(a) / n).is_file():
            assert filecmp.cmp(Path(a) / n, Path(b) / n, shallow=False), n


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _port_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16),
                  "d": [torch.zeros(2), torch.tensor(3, dtype=torch.int32)]},
            "step": np.asarray(7, np.int64),
            "empty": {"norm": {}, "taps": []}}


def test_checkpoint_round_trip_and_empty_containers(tmp_path):
    tree = _port_tree()
    tckpt.save(str(tmp_path), 7, tree)
    out = tckpt.restore_tree(str(tmp_path), device=CPU)
    assert out["empty"] == {"norm": {}, "taps": []}
    assert isinstance(out["b"]["d"], list)
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["a"], tree["a"])
    assert int(out["step"]) == 7 and out["step"].dtype == torch.int64
    like = tckpt.restore(str(tmp_path), tree, device=CPU)
    assert torch.equal(like["b"]["d"][1], tree["b"]["d"][1])
    # placements restore each leaf's block; on a mesh of one rank (a
    # shape record: no process group) every leaf comes back whole
    from torch.distributed.tensor import Shard

    from repro_torch.launch.mesh import MeshShape
    placed = tckpt.restore(str(tmp_path), tree, device=CPU,
                           shardings={"a": (Shard(1),), "b": None},
                           mesh=MeshShape((1,), ("model",)))
    assert torch.equal(placed["a"], tree["a"])
    assert placed["b"]["c"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="no mesh"):
        tckpt.restore(str(tmp_path), tree, shardings={"a": (Shard(1),)},
                      device=CPU)


def test_checkpoint_ignores_a_leftover_tmp_and_rejects_list_keys(tmp_path):
    tckpt.save(str(tmp_path), 1, {"x": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "leaf_00000.npy").write_bytes(b"junk")
    assert tckpt.latest_step(str(tmp_path)) == 1
    assert tckpt.restore_tree(str(tmp_path), device=CPU)["x"].tolist() == [
        1.0, 1.0]
    with pytest.raises(ValueError, match="reserved list encoding"):
        tckpt.save(str(tmp_path), 3, {"__0": torch.ones(1)})


def test_checkpoint_manager_keeps_n(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor([s])})
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_checkpoint_manager_async_snapshot(tmp_path):
    """The snapshot is taken on the caller's thread: writing the tree in
    place after ``save`` does not reach the checkpoint."""
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=3, async_save=True)
    x = torch.arange(10)
    mgr.save(5, {"x": x})
    x.add_(100)
    mgr.wait()
    assert mgr.latest_step() == 5
    out = mgr.restore({"x": None}, device=CPU)
    assert out["x"].tolist() == list(range(10))


DTYPES = {"float32": (np.float32, torch.float32),
          "int8": (np.int8, torch.int8), "uint8": (np.uint8, torch.uint8),
          "int32": (np.int32, torch.int32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "int4": (ml_dtypes.int4, None)}


def _values(name):
    v = np.array([[-8, -3, 0], [1, 5, 7]], np.float32)
    if name == "float32":
        v = v / 3
    elif name == "uint8":
        v = v + 8
    elif name == "bfloat16":
        v = v / 7
    return v


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_checkpoint_leaves_cross_bit_equal(name, writer, tmp_path):
    np_dtype, t_dtype = DTYPES[name]
    ref = np.asarray(_values(name)).astype(np_dtype)
    port = (tckpt.Int4(torch.from_numpy(ref.astype(np.int8)))
            if t_dtype is None else torch.from_numpy(
                np.asarray(_values(name))).to(t_dtype))
    jtree, ttree = {"w": [ref], "k": np.int32(3)}, {"w": [port],
                                                    "k": np.int32(3)}
    jckpt.save(str(tmp_path / "jax"), 2, jtree)
    tckpt.save(str(tmp_path / "torch"), 2, ttree)
    _assert_same_files(tmp_path / "jax", tmp_path / "torch")
    src = tmp_path / writer
    _assert_leaves_equal(tckpt.restore_tree(str(src), device=CPU), jtree)
    back = jckpt.restore_tree(str(src))
    assert back["w"][0].dtype.name == name
    np.testing.assert_array_equal(_bits(back["w"][0]), _bits(ref))


def test_port_loads_without_ml_dtypes(tmp_path):
    """bfloat16 and int4 leaves (and an artifact holding dense int4
    planes) load in a process where ``ml_dtypes`` cannot be imported; the
    training slice's modules import none of it, nor JAX."""
    bf = np.asarray([1.5, -2.25, 3e-3], ml_dtypes.bfloat16)
    i4 = np.asarray([-8, -1, 0, 7], ml_dtypes.int4)
    jckpt.save(str(tmp_path / "ck"), 0, {"bf": bf, "i4": i4})
    cfg = JCIMConfig(**dict(LAYER_CIM, mode="deploy", pack_dtype="int4",
                            array_rows=33))
    x = jax.nn.relu(jax.random.normal(jax.random.PRNGKey(1), (3, 40)))
    art = japi.QuantLinear(40, 6, cfg).init(jax.random.PRNGKey(0)).calibrate(
        x).pack()
    assert np.asarray(art.params["w_digits"]).dtype.name == "int4"
    art.save(str(tmp_path / "art"))
    code = (
        "import json, sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import torch\n"
        "from repro_torch.checkpoint import restore_tree\n"
        "from repro_torch.api import DeployArtifact\n"
        "import repro_torch.train, repro_torch.optim, repro_torch.interop\n"
        "import repro_torch.serve.engine\n"
        f"t = restore_tree({str(tmp_path / 'ck')!r}, device='cpu')\n"
        f"a = DeployArtifact.load({str(tmp_path / 'art')!r}, device='cpu')\n"
        "print(json.dumps([t['bf'].view(torch.int16).tolist(),\n"
        "                  t['i4'].tolist(), str(a.params['w_digits'].dtype),\n"
        "                  sys.modules['ml_dtypes'] is None,\n"
        "                  sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                         in ('jax', 'jaxlib', 'repro'))]))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout) == [bf.view(np.int16).tolist(),
                                    [-8, -1, 0, 7], "torch.int8", True, []]


# ---------------------------------------------------------------------------
# deploy artifacts, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cases():
    """Per kind: the reference's trainable params (numpy), its packs per
    dtype, the port's config, and both packages' forwards."""
    return {}


def _linear_case(pack_dtype):
    jc = JCIMConfig(**LAYER_CIM, pack_dtype=pack_dtype)
    x = np.maximum(np.random.RandomState(1).randn(5, 70), 0).astype(
        np.float32)
    h = japi.QuantLinear(70, 20, jc).init(jax.random.PRNGKey(0)).calibrate(
        jnp.asarray(x))
    jfwd = jax.jit(lambda p, x_: japi.linear(
        x_, p, jc.replace(mode="deploy"), compute_dtype=jnp.float32))
    tc = TCIMConfig(**LAYER_CIM, pack_dtype=pack_dtype)
    return dict(
        art=h.pack(),
        port_pack=lambda: tapi.QuantLinear(70, 20, tc, params=from_numpy_tree(
            _np(h.params), CPU)).pack(),
        jfwd=lambda art: np.asarray(jfwd(art.params, x)),
        tfwd=lambda art: tapi.linear(torch.from_numpy(x), art.params,
                                     art.config,
                                     compute_dtype=torch.float32).numpy())


def _conv_case(pack_dtype):
    jc = JCIMConfig(**dict(LAYER_CIM, array_rows=36), pack_dtype=pack_dtype)
    x = np.maximum(np.random.RandomState(2).randn(2, 9, 9, 12), 0).astype(
        np.float32)
    h = (japi.QuantConv2d(3, 3, 12, 20, jc, stride=2)
         .init(jax.random.PRNGKey(0)).calibrate(jnp.asarray(x)))
    jfwd = jax.jit(lambda p, x_: japi.conv2d(
        x_, p, jc.replace(mode="deploy"), stride=2, compute_dtype=jnp.float32))
    tc = TCIMConfig(**dict(LAYER_CIM, array_rows=36), pack_dtype=pack_dtype)
    return dict(
        art=h.pack(),
        port_pack=lambda: tapi.QuantConv2d(
            3, 3, 12, 20, tc, stride=2,
            params=from_numpy_tree(_np(h.params), CPU)).pack(),
        jfwd=lambda art: np.asarray(jfwd(art.params, x)),
        tfwd=lambda art: tapi.conv2d(
            torch.from_numpy(x), art.params, art.config, stride=2,
            compute_dtype=torch.float32).numpy())


def _resnet_case(pack_dtype):
    jcim = JCIMConfig(**RESNET_CIM, pack_dtype=pack_dtype)
    common = dict(name="tiny", depth=20, n_classes=10, widths=(4, 8, 16),
                  in_hw=8)
    jcfg = jres.ResNetConfig(cim=jcim, **common)
    x = np.random.RandomState(3).randn(8, 8, 8, 3).astype(np.float32)
    params, state = jax.jit(lambda k: jres.init(k, jcfg))(
        jax.random.PRNGKey(0))
    params = jax.jit(lambda p, s, x_: jres.calibrate(p, s, x_, jcfg))(
        params, state, jnp.asarray(x))
    dj = dataclasses.replace(jcfg, cim=jcim.replace(mode="deploy"))
    jfwd = jax.jit(lambda p, s, x_: jres.forward(p, s, x_, dj,
                                                 train=False)[0])
    tcim = TCIMConfig(**RESNET_CIM, pack_dtype=pack_dtype)
    dt = tres.ResNetConfig(cim=tcim.replace(mode="deploy"), **common)
    ts = from_numpy_tree(_np(state), CPU)
    return dict(
        art=japi.model_artifact(params, jcim),
        port_pack=lambda: tapi.model_artifact(
            from_numpy_tree(_np(params), CPU), tcim, device=CPU),
        jfwd=lambda art: np.asarray(jfwd(art.params, state, x)),
        tfwd=lambda art: tres.forward(art.params, ts, x, dt, train=False,
                                      device=CPU)[0].numpy())


def _moe_cfgs(pack_dtype):
    common = dict(compute_dtype="float32", remat=False)
    return (j_get_config(ARCH, reduced=True, cim=JCIMConfig(
                **MOE_CIM, pack_dtype=pack_dtype)).replace(**common),
            get_config(ARCH, reduced=True, cim=TCIMConfig(
                **MOE_CIM, pack_dtype=pack_dtype)).replace(**common))


def _moe_case(pack_dtype):
    jcfg, tcfg = _moe_cfgs(pack_dtype)
    model = j_get_model(jcfg)
    params = jax.jit(lambda k: j_init_params(model.specs(jcfg), k))(
        jax.random.PRNGKey(0))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 6), 0,
                                           jcfg.vocab), np.int32)
    dj = jcfg.replace(cim=jcfg.cim.replace(mode="deploy"))
    jfwd = jax.jit(lambda p, t: model.forward(p, t, dj))
    dt = tcfg.replace(cim=tcfg.cim.replace(mode="deploy"))
    return dict(
        art=japi.model_artifact(params, jcfg.cim),
        port_pack=lambda: tapi.model_artifact(
            from_numpy_tree(_np(params), CPU), tcfg.cim, device=CPU),
        jfwd=lambda art: np.asarray(jfwd(art.params, tokens)),
        tfwd=lambda art: get_model(dt).forward(
            art.params, torch.from_numpy(tokens), dt).numpy())


BUILD = {"linear": _linear_case, "conv": _conv_case,
         "resnet20": _resnet_case, "moonshot": _moe_case}


def _case(cases, kind, pack_dtype):
    key = (kind, pack_dtype)
    if key not in cases:
        cases[key] = BUILD[kind](pack_dtype)
        cases[key]["want"] = cases[key]["jfwd"](cases[key]["art"])
    return cases[key]


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
@pytest.mark.parametrize("kind", sorted(BUILD))
def test_reference_artifact_serves_on_the_port(kind, pack_dtype, cases,
                                               tmp_path):
    c = _case(cases, kind, pack_dtype)
    c["art"].save(str(tmp_path))
    art = tapi.DeployArtifact.load(str(tmp_path), device=CPU)
    assert (art.kind, art.layout_version) == (c["art"].kind, 4)
    assert dataclasses.asdict(art.config) == json.loads(json.dumps(
        dataclasses.asdict(c["art"].config)))
    assert art.meta == json.loads(json.dumps(c["art"].meta))
    _assert_leaves_equal(art.params, _np(c["art"].params))
    np.testing.assert_allclose(c["tfwd"](art), c["want"], **FWD_TOL)


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
@pytest.mark.parametrize("kind", sorted(BUILD))
def test_port_artifact_serves_on_the_reference(kind, pack_dtype, cases,
                                               tmp_path):
    c = _case(cases, kind, pack_dtype)
    art = c["port_pack"]()
    art.save(str(tmp_path / "torch"))
    c["art"].save(str(tmp_path / "jax"))
    _assert_same_files(tmp_path / "torch", tmp_path / "jax")
    loaded = japi.DeployArtifact.load(str(tmp_path / "torch"))
    _assert_jax_trees_equal(loaded.params, c["art"].params)
    np.testing.assert_allclose(c["jfwd"](loaded), c["tfwd"](art), **FWD_TOL)


def _downgrade(tree, unpack, is_nibble):
    """The v3 leaf set of a v4 tree: nibble planes unpacked to dense int4,
    occupancy maps dropped."""
    if isinstance(tree, dict):
        return {k: (_downgrade(v, unpack, is_nibble)
                    if isinstance(v, (dict, list)) else
                    unpack(v) if k.endswith("_digits") and is_nibble(v)
                    else v)
                for k, v in tree.items() if not k.endswith("_occ")}
    if isinstance(tree, list):
        return [_downgrade(v, unpack, is_nibble) for v in tree]
    return tree


def _stamp_v3(art, path):
    dataclasses.replace(art, layout_version=3).save(path)
    with open(os.path.join(path, "artifact.json")) as f:
        assert json.load(f)["layout_version"] == 3


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_v3_artifact_migrates(kind, writer, cases, tmp_path):
    c = _case(cases, kind, "int4")
    path = str(tmp_path / "v3")
    if writer == "jax":
        _stamp_v3(dataclasses.replace(c["art"], params=_downgrade(
            c["art"].params, lambda v: unpack_nibbles(jnp.asarray(v)).astype(
                jnp.int4), is_nibble_packed)), path)
    else:
        fresh = c["port_pack"]()
        _stamp_v3(dataclasses.replace(fresh, params=_downgrade(
            fresh.params, t_unpack_nibbles, lambda v: v.dtype == torch.uint8)),
            path)
    with open(os.path.join(path, "step_00000000", "manifest.json")) as f:
        dtypes = {m["dtype"] for m in json.load(f)["leaves"].values()}
    assert "int4" in dtypes and "uint8" not in dtypes
    art = tapi.DeployArtifact.load(path, device=CPU)
    assert art.layout_version == 4
    _assert_leaves_equal(art.params, _np(c["art"].params))
    np.testing.assert_array_equal(c["tfwd"](art), c["tfwd"](c["port_pack"]()))
    ref = japi.DeployArtifact.load(path)
    _assert_jax_trees_equal(ref.params, c["art"].params)


def _small_port_artifact():
    x = torch.rand(3, 10, generator=torch.Generator().manual_seed(1))
    return tapi.QuantLinear(10, 4, TCIMConfig(**LAYER_CIM)).init(
        0, device=CPU).calibrate(x).pack()


@pytest.mark.parametrize("field,value", [("layout_version", 5),
                                         ("delta_version", 2)])
def test_too_new_version_raises(field, value, tmp_path):
    art = _small_port_artifact()
    art.save(str(tmp_path))
    jpath = tmp_path / "artifact.json"
    head = json.loads(jpath.read_text())
    if field == "layout_version":
        head["layout_version"] = value
    else:
        head["meta"]["delta_version"] = value
    jpath.write_text(json.dumps(head))
    with pytest.raises(tapi.ArtifactVersionError) as err:
        tapi.DeployArtifact.load(str(tmp_path), device=CPU)
    assert (err.value.field, err.value.found) == (field, value)
    with pytest.raises(japi.ArtifactVersionError):
        japi.DeployArtifact.load(str(tmp_path))


def test_unregistered_backend_gives_the_reference_message(tmp_path):
    art = _small_port_artifact()
    art.save(str(tmp_path))
    jpath = tmp_path / "artifact.json"
    head = json.loads(jpath.read_text())
    head["backend"] = head["config"]["mode"] = "photonic"
    jpath.write_text(json.dumps(head))
    with pytest.raises(ValueError) as got:
        tapi.DeployArtifact.load(str(tmp_path), device=CPU)
    with pytest.raises(ValueError) as want:
        japi.DeployArtifact.load(str(tmp_path))
    assert str(got.value) == str(want.value)
    assert "'photonic'" in str(got.value)


def test_load_onto_a_mesh_is_not_ported(tmp_path):
    """Loading onto a mesh is ported (tests/test_torch_serve_sharded.py);
    a mesh that is not a DeviceMesh raises."""
    _linear_case("int8")["port_pack"]().save(str(tmp_path))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tapi.DeployArtifact.load(str(tmp_path), mesh=object(), device=CPU)


def test_engine_from_artifact_path_serves_the_same_tokens(cases, tmp_path):
    c = _case(cases, "moonshot", "int4")
    _, tcfg = _moe_cfgs("int4")
    art = c["port_pack"]()
    art.save(str(tmp_path / "torch"))
    c["art"].save(str(tmp_path / "jax"))
    prompts = np.asarray([[3, 5, 7, 9], [11, 13, 2, 4]], np.int32)
    kw = dict(batch_size=2, max_len=16, device=CPU)
    want = engine_from_artifact(art, tcfg, **kw).generate_batch(prompts, 4)
    for path in ("torch", "jax"):
        eng = engine_from_artifact(str(tmp_path / path), tcfg, **kw)
        assert eng.cfg.cim == art.config
        np.testing.assert_array_equal(eng.generate_batch(prompts, 4), want)
    with pytest.raises(TypeError, match="DeployArtifact or its path"):
        engine_from_artifact(art.params, tcfg, **kw)


def test_interop_shares_the_loader_decoder():
    tree = {"bf": np.asarray([1.5, -2.0], ml_dtypes.bfloat16),
            "i4": np.asarray([-8, 7], ml_dtypes.int4)}
    t = from_numpy_tree(tree, CPU)
    assert t["bf"].dtype == torch.bfloat16 and t["i4"].dtype == torch.int8
    assert t["i4"].tolist() == [-8, 7]
    np.testing.assert_array_equal(
        to_numpy_tree({"bf": t["bf"].view(torch.int16)})["bf"],
        tree["bf"].view(np.int16))
