"""The port's in-service recalibration (``repro_torch.eval.recalibrate``)
against the JAX package's, on the CPU.

The pristine planes are packed by the port, the observed (drifted)
planes are the reference's ``drift_tree`` output, and the probe codes are
the reference's Rademacher draws (``path_fold_key`` per node), handed in
through ``codes=``. Per-column gains then match the reference's at rtol
1e-5 (float32 sums in another order), on linear and conv nodes, stacked
nodes and nibble-packed pristine planes; the applied ``s_p`` and
``deq_scale`` at rtol 1e-6. The reference's recovery gate holds on the
port's own drift; a delta saved by either package loads in the other
bit-equal; future, stale and compounding deltas raise the reference's
errors.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import variation as jvar
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.eval import recalibrate as jrec
from repro_torch import api as tapi
from repro_torch.api import ArtifactVersionError, DeployArtifact
from repro_torch.core import variation as tvar
from repro_torch.core.cim_linear import CIMConfig as TCIMConfig
from repro_torch.eval import recalibrate as rec
from repro_torch.interop import from_numpy_tree, to_numpy_tree

CPU = "cpu"
SCHED = dict(read_sigma=0.02, read_rate=0.0, cell_rate=2e-4, col_rate=1e-3)
PROBES = 16


def _cfgs(**kw):
    base = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                act_bits=6, psum_bits=6, array_rows=32, array_cols=32)
    base.update(kw)
    return JCIMConfig(**base), TCIMConfig(**base)


def _linear(tc, seed=0, k=70, n=24, b=8):
    x = (np.random.RandomState(seed).randn(b, k) * 0.5).astype(np.float32)
    p = tapi.init_linear(torch.Generator().manual_seed(seed), k, n, tc,
                         device=CPU)
    return tapi.calibrate_linear(torch.from_numpy(x), p, tc), x


def _conv(tc, seed=0):
    x = (np.random.RandomState(seed).randn(2, 8, 8, 8) * 0.5).astype(
        np.float32)
    p = tapi.init_conv(torch.Generator().manual_seed(seed), 3, 3, 8, 16, tc,
                       device=CPU)
    return tapi.calibrate_conv(torch.from_numpy(x), p, tc), x


def _stack(nodes):
    return {k: torch.stack([nd[k] for nd in nodes]) for k in nodes[0]}


def _tree(pack_dtype):
    """A packed tree with a linear node, a conv node and a stacked linear
    node (a leading layer axis), by the port's packers."""
    _, tc = _cfgs(pack_dtype=pack_dtype)
    dc = tc.replace(mode="deploy")
    lin = tapi.pack_linear(_linear(tc)[0], dc)
    conv = tapi.pack_conv(_conv(tc)[0], dc)
    layers = _stack([tapi.pack_linear(_linear(tc, seed=s)[0], dc)
                     for s in (1, 2)])
    return {"lin": lin, "blk": {"conv": conv}, "layers": {"wq": layers}}


def _j(tree):
    return jax.tree.map(jnp.asarray, to_numpy_tree(tree))


def _j_codes(key, tree, probes):
    """The reference's probe codes of every node of ``tree``."""
    out = {}

    def walk(node, path):
        if "w_digits" in node:
            planes = rec._row_flat(node["w_digits"])
            kt, rows = planes.shape[-3], planes.shape[-2]
            out["/".join(path)] = np.asarray(jax.random.rademacher(
                jvar.path_fold_key(key, path), (probes, kt, rows),
                jnp.float32))
            return
        for k, v in node.items():
            walk(v, path + (k,))
    walk(tree, ())
    return out


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_fit_and_apply_match_the_reference(pack_dtype):
    tree = _tree(pack_dtype)
    jtree = _j(tree)
    key = jax.random.PRNGKey(2)
    jobs = jvar.drift_tree(jtree, key, jvar.DriftSchedule(**SCHED).at(200))
    obs = from_numpy_tree(jax.tree.map(np.asarray, jobs), CPU)
    pkey = jax.random.PRNGKey(3)
    want = jrec.fit_scale_delta(jtree, jobs, key=pkey, probes=PROBES,
                                meta={"t": 200})
    codes = _j_codes(pkey, tree, PROBES)
    got = rec.fit_scale_delta(tree, obs, codes=codes, meta={"t": 200})
    assert sorted(got.gains) == sorted(want.gains) == [
        "blk/conv", "layers/wq", "lin"]
    assert got.gains["layers/wq"].shape == (2, 2, 3, 24)
    for name, g in got.gains.items():
        assert g.dtype == torch.float32 and g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), want.gains[name], rtol=1e-5,
                                   atol=0)
        # node_gain alone, on the same codes
        node = name.split("/")
        r, o = tree, obs
        for part in node:
            r, o = r[part], o[part]
        np.testing.assert_array_equal(
            rec.node_gain(r["w_digits"], o["w_digits"],
                          codes=codes[name]).numpy(), g.numpy())
    assert got.meta == want.meta == {"t": 200}
    assert got.layout_version == want.layout_version

    # applied on the same gains: the reference's s_p and deq_scale
    same = rec.ScaleDelta(gains={k: torch.from_numpy(np.array(v))
                                 for k, v in want.gains.items()})
    a = rec.apply_scale_delta_params(tree, same)
    ja = jrec.apply_scale_delta_params(jtree, want)
    for name in want.gains:
        node, jnode = a, ja
        for part in name.split("/"):
            node, jnode = node[part], jnode[part]
        for leaf in ("s_p", "deq_scale"):
            np.testing.assert_allclose(node[leaf].numpy(),
                                       np.asarray(jnode[leaf]), rtol=1e-6,
                                       atol=0)
    # the planes and the other leaves pass through as the same objects
    assert a["lin"]["w_digits"] is tree["lin"]["w_digits"]
    assert a["layers"]["wq"]["s_w"] is tree["layers"]["wq"]["s_w"]
    assert rec.apply_scale_delta_params(
        tree, rec.ScaleDelta(gains={}))["lin"] is tree["lin"]


def test_probes_from_a_generator():
    tree = _tree("int8")
    obs = tvar.drift_tree(tree, tvar.Sampler(0),
                          tvar.DriftSchedule(**SCHED).at(100))
    a = rec.fit_scale_delta(tree, obs, gen=torch.Generator().manual_seed(4))
    b = rec.fit_scale_delta(tree, obs, gen=torch.Generator().manual_seed(4))
    for name in a.gains:
        assert torch.equal(a.gains[name], b.gains[name])
    with pytest.raises(ValueError, match="codes"):
        rec.node_gain(tree["lin"]["w_digits"], obs["lin"]["w_digits"])
    codes = rec.rademacher_codes(torch.Generator().manual_seed(0), 8, 3, 32)
    assert codes.shape == (8, 3, 32)
    assert set(codes.unique().tolist()) == {-1.0, 1.0}
    # a column gain is recovered; a dead column carries no signal: gain 1
    d = tree["lin"]["w_digits"].clone()
    d[..., 0] = 0
    g = rec.node_gain(d, d.to(torch.float32) * 1.5, codes=codes)
    alive = (d != 0).any(dim=2)
    assert not alive[..., 0].any() and alive.sum() > alive.numel() // 2
    assert torch.all(g[~alive] == 1.0)
    torch.testing.assert_close(g[alive], torch.full_like(g[alive], 1.5))


@pytest.mark.parametrize("pack_dtype", ["int8", "int4"])
def test_recalibration_recovers_column_drift(pack_dtype):
    """The reference's gate (tests/test_drift.py): under pure column drift
    the recalibrated deploy output is much closer to clean than the
    drifted one (exact recovery is impossible: the ADC re-rounds)."""
    _, tc = _cfgs(pack_dtype=pack_dtype)
    p, x = _linear(tc)
    dc = tc.replace(mode="deploy")
    tree = {"lin": tapi.pack_linear(p, dc)}
    drifted = tvar.drift_tree(tree, tvar.Sampler(11),
                              tvar.DriftSchedule(col_rate=1e-3).at(400))
    xt = torch.from_numpy(x)
    y_clean = tapi.linear(xt, tree["lin"], dc, compute_dtype=torch.float32)
    y_drift = tapi.linear(xt, drifted["lin"], dc, compute_dtype=torch.float32)
    delta = rec.fit_scale_delta(tree, drifted,
                                gen=torch.Generator().manual_seed(1),
                                probes=32)
    recal = rec.apply_scale_delta_params(drifted, delta)
    assert "deq_scale" in recal["lin"]
    y_recal = tapi.linear(xt, recal["lin"], dc, compute_dtype=torch.float32)
    e_drift = float(torch.linalg.norm(y_drift - y_clean))
    e_recal = float(torch.linalg.norm(y_recal - y_clean))
    assert e_recal < 0.34 * e_drift, (e_drift, e_recal)


def _delta(pack_dtype="int8"):
    tree = _tree(pack_dtype)
    obs = tvar.drift_tree(tree, tvar.Sampler(2),
                          tvar.DriftSchedule(**SCHED).at(200))
    return tree, rec.fit_scale_delta(tree, obs,
                                     gen=torch.Generator().manual_seed(3),
                                     meta={"t": 200})


def test_deltas_cross_between_the_packages(tmp_path):
    tree, delta = _delta()
    # the port writes, the reference reads (one-part node names: the
    # reference's loader nests '/'-joined names, ROADMAP fault 6)
    flat = rec.ScaleDelta(gains={"lin": delta.gains["lin"]},
                          meta={"t": 200})
    flat.save(str(tmp_path / "port"))
    j = jrec.ScaleDelta.load(str(tmp_path / "port"))
    assert (j.delta_version, j.layout_version, j.meta) == (
        flat.delta_version, flat.layout_version, flat.meta)
    np.testing.assert_array_equal(j.gains["lin"], flat.gains["lin"].numpy())
    # the reference writes, the port reads, nested node names included
    jd = jrec.ScaleDelta(gains={k: v.numpy() for k, v in delta.gains.items()},
                         meta={"t": 200, "probes": 32})
    jd.save(str(tmp_path / "ref"))
    got = rec.ScaleDelta.load(str(tmp_path / "ref"))
    assert sorted(got.gains) == sorted(delta.gains)
    for k, v in delta.gains.items():
        assert torch.equal(got.gains[k], v)
    assert got.meta == {"t": 200, "probes": 32}
    # the port's own round trip, and the same applied scales
    delta.save(str(tmp_path / "again"))
    back = rec.ScaleDelta.load(str(tmp_path / "again"))
    a = rec.apply_scale_delta_params(tree, delta)
    b = rec.apply_scale_delta_params(tree, back)
    for node in (("lin",), ("blk", "conv"), ("layers", "wq")):
        x, y = a, b
        for part in node:
            x, y = x[part], y[part]
        assert torch.equal(x["s_p"], y["s_p"])
        assert torch.equal(x["deq_scale"], y["deq_scale"])
    # the same files as the reference's writer
    names = sorted(os.listdir(tmp_path / "again" / "step_00000000"))
    jnames = sorted(os.listdir(tmp_path / "ref" / "step_00000000"))
    assert names == jnames


def _artifact():
    _, tc = _cfgs()
    p, _ = _linear(tc)
    dc = tc.replace(mode="deploy")
    return DeployArtifact(kind="linear", params=tapi.pack_linear(p, dc),
                          config=dc)


def test_future_stale_and_compounding_deltas_raise(tmp_path):
    art = _artifact()
    obs = tvar.drift_tree({"p": art.params}, tvar.Sampler(2),
                          tvar.DriftSchedule(**SCHED).at(50))["p"]
    delta = rec.fit_scale_delta(art.params, obs,
                                gen=torch.Generator().manual_seed(3))
    # a future delta format: refused on load, by both packages
    newer = dataclasses.replace(delta,
                                delta_version=rec.SCALE_DELTA_VERSION + 1)
    newer.save(str(tmp_path / "newer"))
    for load in (rec.ScaleDelta.load, jrec.ScaleDelta.load):
        with pytest.raises(ValueError, match="delta_version"):
            load(str(tmp_path / "newer"))
    with pytest.raises(ArtifactVersionError, match="delta_version"):
        rec.ScaleDelta.load(str(tmp_path / "newer"))
    with pytest.raises(ArtifactVersionError, match="delta_version"):
        rec.apply_scale_delta(art, newer)
    with pytest.raises(FileNotFoundError, match="delta.json"):
        rec.ScaleDelta.load(str(tmp_path))
    # a stale delta: fitted against another layout
    stale = dataclasses.replace(delta, layout_version=art.layout_version + 1)
    with pytest.raises(ArtifactVersionError, match="layout_version") as ei:
        rec.apply_scale_delta(art, stale)
    assert isinstance(ei.value, ValueError) and "re-fit" in str(ei.value)
    # a fresh delta applies once; applying again would compound
    recal = rec.apply_scale_delta(art, delta)
    assert recal.meta["delta_version"] == delta.delta_version
    assert "deq_scale" in recal.params
    with pytest.raises(ValueError, match="absolute"):
        rec.apply_scale_delta(recal, delta)
    # the reference's error, field for field (the writers' names in the
    # message are the port's own)
    jart = japi.DeployArtifact(kind="linear", params=_j(art.params),
                               config=JCIMConfig(**dataclasses.asdict(
                                   art.config)))
    jdelta = jrec.ScaleDelta(gains={"": delta.gains[""].numpy()})
    jstale = dataclasses.replace(jdelta,
                                 layout_version=jart.layout_version + 1)
    with pytest.raises(ValueError) as jei:
        jrec.apply_scale_delta(jart, jstale)
    assert type(jei.value).__name__ == type(ei.value).__name__
    assert ((ei.value.field, ei.value.found, ei.value.supported)
            == (jei.value.field, jei.value.found, jei.value.supported))
    head = str(ei.value).split(" (written by")[0].split(";")[0]
    assert str(jei.value).startswith(head)
