"""The expert-parallel MoE and the sequence-parallel flash decode of the
port (``models/layers.py`` ``_apply_moe_ep``, ``_flash_decode_ep``) on four
gloo ranks on the CPU, against the reference's four-device ``shard_map``
paths and against the port's single device.

One subprocess runs the reference under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_torch_mesh.py`` does) while the port's ranks run
(``tests/_torch_parallel_ranks.py``, spawned once for the file); the
JAX package initialises every param tree, and the inputs are numpy from
seeds. Cases and tolerances, in float32 compute:

- the MoE block's output and gradients (the expert banks, their scales,
  the router, the shared experts, the input) on a ``("model",)`` mesh of
  4 and a ``("data", "model")`` mesh of (2, 2), under CIM emulate, and
  where the capacity drops tokens. Against the port's single device (the
  jit path): everything at rtol 1e-5 / atol 1e-6 of each leaf's largest
  magnitude. Against the reference: the output and the input's gradient
  there too, the parameter gradients at 1e-4 of each leaf's largest
  magnitude (``_torch_lm_train``'s tolerance: the port's single device
  already differs from the reference by up to 2.3e-5 on the shared
  experts' LSQ scales, float32's order of summation). Six experts on
  four ranks take the jit path, as the reference's predicate sends
  them;
- flash decode with the bf16 and the int8 caches, the prefill included,
  on both meshes (on the ``("data", "model")`` one through the serve
  cell's data parallel step, each rank on its rows, the logits gathered
  whole): logits within 1e-5 of the reference's (which differ
  from its own unsharded decode by about 3e-7), tokens identical, the
  caches time-sharded; the engine's tokens under a mesh equal the
  reference's, and a packed artifact served with ``mesh=`` and flash
  decode gives the single device's tokens;
- one AdamW step (clipping on) of the reduced moonshot with its expert
  banks placed over the ranks equals the single device's step: loss and
  gradient norm at rtol 1e-5, moments at 1e-5 of each leaf's largest
  magnitude, params within ``_torch_lm_train``'s one-step bound;
- the ADC collector's totals under expert parallelism equal the single
  device's, as the reference's host callbacks count them on four
  devices (a replicated layer once);
- ``param_shardings`` equals the reference's ``logical_to_mesh`` on every
  config, and ``shard_params`` places every config's tree on the (2, 2)
  mesh as the reference's ``build_cell`` does.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as R
import _torch_parallel_ranks as P
from _torch_lm_train import _assert_step_close, assert_tree_close
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.launch import mesh as jmesh
from repro.models import layers as jlayers
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro.nn import module as jmod
from repro_torch import tree_map
from repro_torch.configs.registry import get_config
from repro_torch.models.registry import get_model
from repro_torch.nn import module as tmod

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
FD_TOL = dict(rtol=1e-5, atol=1e-5)

_REFERENCE = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_config
    from repro.core.cim_linear import CIMConfig
    from repro.models import layers
    from repro.models.registry import get_model
    from repro.nn.module import session_mesh
    from repro.obs import adc
    assert len(jax.devices()) == 4
    d = sys.argv[1]
    with open(d + "/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    MESHES = inp["meshes"]
    npy = lambda t: jax.tree.map(np.asarray, t)

    def moe_cfg(cim, moe):
        cfg = get_config("moonshot-v1-16b-a3b", reduced=True,
                         cim=None if cim is None else CIMConfig(**cim))
        cfg = cfg.replace(compute_dtype="float32", remat=False,
                          moe_impl="ep")
        return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))

    out = {"moe": {}, "fd": {}}
    for name, c in inp["moe"].items():
        cfg = moe_cfg(c["cim"], c["moe"])
        mesh = jax.make_mesh(*MESHES[c["mesh"]])
        proj = jnp.asarray(c["proj"])

        def loss(p, x):
            y = layers.apply_moe(p, x, cfg)
            return jnp.sum(y * proj), y
        with session_mesh(mesh):
            (l, y), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(
                    jax.tree.map(jnp.asarray, c["params"]),
                    jnp.asarray(c["x"]))
        out["moe"][name] = dict(y=np.asarray(y), loss=float(l),
                                grads=npy(gp), gx=np.asarray(gx))

    for name, c in inp["fd"].items():
        cfg = get_config("llama3-8b", reduced=True).replace(
            compute_dtype="float32", attn_chunk=0, flash_decode=True,
            kv_cache_dtype=c["kv"])
        model = get_model(cfg)
        mesh = jax.make_mesh(*MESHES[c["mesh"]])
        params = jax.tree.map(jnp.asarray, c["params"])
        with session_mesh(mesh):
            step = jax.jit(lambda p, cc, t: model.decode_step(p, cc, t, cfg))
            cache = model.init_cache(cfg, c["prompts"].shape[0], c["max_len"])
            logits, cache = step(params, cache, jnp.asarray(c["prompts"]))
            ls, toks = [], []
            for _ in range(c["steps"] + 1):
                ls.append(np.asarray(logits))
                toks.append(np.argmax(ls[-1][:, -1], -1)[:, None].astype(
                    np.int32))
                if len(toks) <= c["steps"]:
                    logits, cache = step(params, cache, jnp.asarray(toks[-1]))
        out["fd"][name] = dict(logits=ls, tokens=np.concatenate(toks, 1))

    c = inp["adc"]
    cfg = moe_cfg(c["cim"], {})
    params = jax.tree.map(jnp.asarray, c["params"])
    out["adc"] = {}
    for where in ("single", "mesh"):
        mesh = jax.make_mesh((4,), ("model",)) if where == "mesh" else None
        with session_mesh(mesh), adc.sampled():
            jax.block_until_ready(jax.jit(lambda p, x: layers.apply_moe(
                p, x, cfg))(params, jnp.asarray(c["x"])))
            out["adc"][where] = adc.totals()
    from repro.launch.cells import build_cell
    from repro.configs.registry import ARCHS
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out["placements"] = {}
    for arch in sorted(ARCHS):
        cell = build_cell(arch, "train_4k", mesh, reduced=True)
        flat = {}
        def walk(sh, st, path=""):
            if isinstance(sh, dict):
                for k in sh:
                    walk(sh[k], st[k], path + "/" + k)
                return
            flat[path] = (tuple(sh.spec), tuple(sh.shard_shape(st.shape)))
        walk(cell.in_shardings[0], cell.arg_structs[0])
        out["placements"][arch] = flat
    with open(d + "/reference.pkl", "wb") as f:
        pickle.dump(out, f)
""")


def _jax_moe_cfg(cim, moe):
    import dataclasses
    cfg = j_get_config(P.MOE_ARCH, reduced=True,
                       cim=None if cim is None else JCIMConfig(**cim))
    cfg = cfg.replace(compute_dtype="float32", remat=False, moe_impl="ep")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))


def _npy(tree):
    return jax.tree.map(np.asarray, tree)


def _scaled_s_p(tree, by):
    """Every partial-sum scale of a param tree times ``by`` (narrower ADC
    ranges than initialised, so some conversions clip)."""
    if isinstance(tree, dict):
        return {k: (v * by if k == "s_p" or k.endswith("_s_p")
                    else _scaled_s_p(v, by)) for k, v in tree.items()}
    return tree


def _moe_params(cim, moe, memo={}):
    """The JAX package's init of the MoE block (seed 1), one per distinct
    spec tree (the capacity factor changes no spec)."""
    key = (repr(cim), moe.get("n_experts"))
    if key not in memo:
        cfg = _jax_moe_cfg(cim, moe)
        memo[key] = _npy(jax.jit(lambda k: j_init_params(
            jlayers.moe_specs(cfg), k))(jax.random.PRNGKey(1)))
    return memo[key]


def _inputs():
    """The cases' params (the JAX package's init) and numpy inputs."""
    inp = {"meshes": P.MESHES, "moe": {}, "fd": {}}
    for name, (mesh, cim, b, t, moe) in P.MOE_CASES.items():
        cfg = _jax_moe_cfg(cim, moe)
        rs = np.random.RandomState(3)
        inp["moe"][name] = dict(
            name=name, mesh=mesh, cim=cim, moe=moe,
            params=_moe_params(cim, moe),
            x=rs.randn(b, t, cfg.d_model).astype(np.float32),
            proj=rs.randn(b, t, cfg.d_model).astype(np.float32))
    cfg = j_get_config(P.LM_ARCH, reduced=True).replace(
        compute_dtype="float32")
    lm = _npy(jax.jit(lambda k: j_init_params(
        j_get_model(cfg).specs(cfg), k))(jax.random.PRNGKey(0)))
    prompts = np.random.RandomState(5).randint(
        0, cfg.vocab, (P.FD_BATCH, P.FD_PROMPT)).astype(np.int32)
    for name, (mesh, kv) in P.FD_CASES.items():
        inp["fd"][name] = dict(name=name, mesh=mesh, kv=kv, params=lm,
                               prompts=prompts, max_len=P.FD_MAX_LEN,
                               steps=P.FD_STEPS)
    inp["adc"] = dict(cim=R.CIM, params=_scaled_s_p(_moe_params(R.CIM, {}),
                                                    0.02),
                      x=np.random.RandomState(6).randn(
                          2, 8, cfg.d_model).astype(np.float32))
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's ranks' results, the reference's, the inputs)."""
    out = tmp_path_factory.mktemp("parallel_layers")
    inputs = _inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(out)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: ref.poll() is None and ref.kill())
        ranks = R.run_ranks(P.body, WORLD, str(out), timeout_s=240)
        log = ref.communicate(timeout=240)[0]
    assert ref.returncode == 0, log[-3000:]
    with open(out / "reference.pkl", "rb") as f:
        reference = pickle.load(f)
    return ranks, reference, inputs


def _close(got, want, path=""):
    """Trees of tensors against trees of numpy arrays, leaf by leaf, at
    rtol 1e-5 and atol 1e-6 of the leaf's largest magnitude (float32's
    resolution at that scale: the gradients reach 80, and the port's
    single device differs from the reference there by a few ulps of it)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=1e-5, err_msg=path,
        atol=1e-6 * max(1.0, float(np.abs(want).max(initial=0.0))))


def _loss_close(got, want, y, proj):
    """The loss sum(y * proj) within 1e-6 of the sum of its terms'
    magnitudes (it cancels: float32's order of summation shows there)."""
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 * float(np.abs(y * proj).sum()))


def _drops(case):
    """Token-expert pairs the reference's expert-parallel capacity drops
    on one batch block of ``case`` (numpy, from its inputs)."""
    _, _, b, t, moe = P.MOE_CASES[case["name"]]
    cfg = _jax_moe_cfg(None, moe)
    mo = cfg.moe
    x = case["x"].reshape(b * t, -1)
    logits = x @ case["params"]["router"]["w"]
    sel = np.argsort(-logits, axis=-1, kind="stable")[:, :mo.top_k]
    n = b * t * mo.top_k
    cap = n if n <= 256 else max(int(mo.capacity_factor * n
                                     / mo.n_experts) + 1, 4)
    per = np.bincount(sel.reshape(-1), minlength=mo.n_experts)
    return int(np.maximum(per - cap, 0).sum())


@pytest.mark.parametrize("name", ["ep4", "ep22", "ep4_cim", "ep4_drop"])
def test_expert_parallel_moe_matches_the_reference(runs, name):
    ranks, ref, inputs = runs
    want = ref["moe"][name]
    if name == "ep4_drop":
        assert _drops(inputs["moe"][name]) > 0
    e = P.moe_cfg(P.MOE_CASES[name][1], **P.MOE_CASES[name][4]).moe.n_experts
    proj = inputs["moe"][name]["proj"]
    for res in ranks:
        r = res["moe"][name]
        y, loss, grads, gx = r["mesh"]
        _close({"y": y, "gx": gx}, {"y": want["y"], "gx": want["gx"]})
        _loss_close(float(loss), want["loss"], want["y"], proj)
        assert_tree_close(grads, want["grads"])
        # against the port's single device (the jit path), which differs
        # from the reference by float32's order of summation alone
        y1, _, grads1, gx1 = r["single"]
        _close({"y": y, "gx": gx, "grads": grads},
               _numpy({"y": y1, "gx": gx1, "grads": grads1}))
        assert r["ep_calls"] > 0 and r["collectives"] > 0
        model = P.MESHES[P.MOE_CASES[name][0]][0][-1]
        assert r["bank"] == ("DTensor", (e // model,) + r["bank"][1][1:])


def _numpy(tree, by=1.0):
    """A tree of tensors as numpy, each leaf times ``by``."""
    if isinstance(tree, dict):
        return {k: _numpy(v, by) for k, v in tree.items()}
    return tree.detach().numpy() * by


def test_experts_that_do_not_divide_take_the_jit_path(runs):
    ranks, ref, _ = runs
    want = ref["moe"]["jit6"]
    for res in ranks:
        r = res["moe"]["jit6"]
        y, loss, grads, gx = r["mesh"]
        assert r["ep_calls"] == 0 and r["collectives"] == 0
        assert r["bank"][0] == "Tensor"
        _close({"y": y, "gx": gx}, {"y": want["y"], "gx": want["gx"]})
        assert_tree_close(grads, want["grads"])
        y1, _, grads1, gx1 = r["single"]        # the same path as one device
        assert torch.equal(y, y1) and torch.equal(gx, gx1)


@pytest.mark.parametrize("name", list(P.FD_CASES))
def test_flash_decode_matches_the_reference(runs, name):
    ranks, ref, _ = runs
    want = ref["fd"][name]
    first = ranks[0]["fd"][name]["mesh"]
    for res in ranks:
        r = res["fd"][name]
        logits, tokens = r["mesh"]
        np.testing.assert_array_equal(tokens.numpy(), want["tokens"])
        assert len(logits) == len(want["logits"]) == P.FD_STEPS + 1
        for got, w, one in zip(logits, want["logits"], r["single"][0]):
            np.testing.assert_allclose(got.numpy(), w, **FD_TOL)
            np.testing.assert_allclose(got.numpy(), one.numpy(), **FD_TOL)
        np.testing.assert_array_equal(tokens.numpy(), r["single"][1].numpy())
        for got, other in zip(logits, first[0]):       # every rank alike
            assert torch.equal(got, other)
        assert r["collectives"] > 0


@pytest.mark.parametrize("name", list(P.FD_CASES))
def test_flash_decode_cache_is_time_sharded(runs, name):
    ranks, _, inputs = runs
    mesh, kv = P.FD_CASES[name]
    shape, axes = P.MESHES[mesh]
    nb = shape[0] if "data" in axes else 1
    cfg = P.fd_cfg(kv)
    full = (cfg.n_layers, P.FD_BATCH, P.FD_MAX_LEN, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    block = (full[0], full[1] // nb, full[2] // shape[-1]) + full[3:]
    names = ("k", "v", "k_scale", "v_scale") if kv == "int8" else ("k", "v")
    for res in ranks:
        cache = res["fd"][name]["cache"]
        assert set(cache) == set(names) | {"len"}
        for n in names:
            depth = 5 if n in ("k", "v") else 4
            assert cache[n] == ("DTensor", full[:depth], block[:depth]), n
        # the lengths hold their rows over "data" too (the reference's
        # cache_shardings), the time-sharded leaves' rows with them
        assert cache["len"] == (("DTensor" if nb > 1 else "Tensor"),
                                full[:2], block[:2])


@pytest.mark.parametrize("arch", P.FD_ZOO)
def test_flash_decode_on_the_other_families_equals_one_device(runs, arch):
    """zamba2's shared attention block and whisper's decoder self-attention
    allocate time-sharded caches under the mesh and decode as one device
    does (logits at 1e-5, tokens identical)."""
    ranks, _, _ = runs
    for res in ranks:
        (l1, t1), (l4, t4), placed = res["fd_zoo"][arch]
        assert placed == "DTensor"
        np.testing.assert_array_equal(t4.numpy(), t1.numpy())
        for a, b in zip(l4, l1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **FD_TOL)


def test_engine_serves_flash_decode_under_a_mesh(runs):
    ranks, ref, _ = runs
    for res in ranks:
        np.testing.assert_array_equal(res["fd"]["fd_bf16"]["engine"],
                                      ref["fd"]["fd_bf16"]["tokens"])
        single, sharded, placed = res["engine_artifact"]
        np.testing.assert_array_equal(sharded, single)
        assert placed == "DTensor"


@pytest.mark.parametrize("mesh", list(P.MESHES))
def test_adamw_step_on_expert_parallel_ranks_equals_one_device(runs, mesh):
    ranks, _, _ = runs
    for res in ranks:
        r = res["adamw"][mesh]
        loss1, gn1, params1, mom1 = r["single"]
        loss, gn, params, mom = r["mesh"]
        assert gn1 > P.RUN["grad_clip"]                      # clipping on
        np.testing.assert_allclose(loss, loss1, rtol=1e-5)
        np.testing.assert_allclose(gn, gn1, rtol=1e-5)
        # after one step m = (1 - b1) g, g the clipped gradient
        _assert_step_close(params, _numpy(params1),
                           tree_map(lambda m: m / 0.1, mom["m"]),
                           _numpy(mom1["m"], 1 / 0.1), P.RUN["lr"])
        assert_tree_close(mom["m"], _numpy(mom1["m"]), rel=1e-5)
        assert_tree_close(mom["v"], _numpy(mom1["v"]), rel=1e-5)
        banks = {f"/moe_layers/moe/{k}" for k in ("wg", "wu", "wd")}
        assert banks <= set(r["placed"])
        assert all("/moe/w" in p for p in r["placed"]), r["placed"]


def test_adc_totals_under_expert_parallelism_equal_one_device(runs):
    ranks, ref, _ = runs
    want = tuple(ref["adc"]["single"])
    assert tuple(ref["adc"]["mesh"]) == want and want[0] > 0
    for res in ranks:
        assert tuple(res["adc"]["single"]) == want
        assert tuple(res["adc"]["mesh"]) == want


@pytest.mark.parametrize("what", sorted(J_ARCHS))
def test_shard_params_raises_on_placements_left_to_12b3(runs, what):
    """(The name is kept from the slice that refused these placements.)
    ``shard_params`` places each config's reduced tree under the full
    ``sharding_rules`` of the (2, 2) mesh, FSDP as ``RUN_HINTS`` say, as
    the reference's ``build_cell`` places it: every leaf's local block has
    the shape of the reference's shard, and its placements are the
    reference's (truncated) ``PartitionSpec``."""
    ranks, ref, _ = runs
    want = ref["placements"][what]
    for res in ranks:
        got = res["placements"][what]
        assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
        for path, (shape, local, pl) in got.items():
            spec, shard = want[path]
            assert local == shard, (what, path, local, shard)
            placed = _reference_placements(spec, ("data", "model"))
            if any(k == "S" for k, _ in placed):
                assert pl == placed, (what, path, pl, placed)
            else:
                assert pl is None and local == shape, (what, path, pl)
    assert any(pl is not None and ("S", 0) in pl and ("S", 1) in pl
               for pl in (v[2] for v in ranks[0]["placements"][
                   "llama3-8b"].values()) if pl)


def _reference_placements(pspec, axes):
    """The placements the reference's ``PartitionSpec`` means over mesh
    dims ``axes``, as (kind, dim) pairs."""
    out = []
    for name in axes:
        dim = next((i for i, e in enumerate(pspec) if e == name or (
            isinstance(e, tuple) and name in e)), None)
        out.append(("R", None) if dim is None else ("S", dim))
    return tuple(out)


def _pairs(tree):
    if isinstance(tree, dict):
        return {k: _pairs(v) for k, v in tree.items()}
    return tuple(("S", p.dim) if p.is_shard() else ("R", None) for p in tree)


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_param_shardings_match_the_reference(arch):
    jcfg = j_get_config(arch)
    tcfg = get_config(arch)
    jspecs = j_get_model(jcfg).specs(jcfg)
    tspecs = get_model(tcfg).specs(tcfg)
    for axes in (("model",), ("data", "model"), ("pod", "data", "model")):
        jm = jax.make_mesh((1,) * len(axes), axes)
        tm = types.SimpleNamespace(mesh_dim_names=axes)
        for fsdp in (False, True):
            want = jax.tree.map(
                lambda s: _reference_placements(tuple(s), axes),
                jmod.logical_to_mesh(jspecs, jmesh.sharding_rules(
                    jm, fsdp=fsdp)),
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
            got = _pairs(tmod.param_shardings(
                tspecs, tm, jmesh.sharding_rules(jm, fsdp=fsdp)))
            assert got == want, (arch, axes, fsdp)
