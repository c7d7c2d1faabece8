"""FSDP and raw-weight tensor parallelism of the port over a ``("data",
"model")`` mesh (``launch/cells.py``, ``nn.module.shard_params``,
``nn/linear.py``'s placed linears, the data parallel train step), and
checkpoints restored across meshes and packages, on four gloo ranks on
the CPU against the reference's GSPMD step on four host devices.

One subprocess runs the reference under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` while the port's
ranks run (``tests/_torch_fsdp_ranks.py``, spawned once for the file).
The JAX package initialises every param tree; the batches are numpy from
seeds. The reference's step is ``make_train_step`` jitted with the
``in_shardings`` of its ``build_cell`` on a (2, 2) mesh; the port's ranks
place the same params with its own ``build_cell``'s placements. Cases, in
float32 compute, one AdamW step (lr 1e-3, warmup 2):

- the reduced llama3-8b with ``fsdp=True`` (embed over ``data``, heads,
  mlp and vocab over ``model``), under CIM off and under emulate on 32 x
  32 arrays: its ``wo`` is tile-aligned per rank, its ``wd`` (80 rows a
  rank) is gathered at use; the reduced qwen3-0.6b with ``fsdp=False``
  (tensor parallelism alone, tied embeddings);
- against the reference: the loss at rtol 1e-5, the moments at 1e-4 of
  each leaf's largest magnitude and the params within
  ``_torch_lm_train``'s one-step bound at that tolerance; against the
  port's single device the same at 1e-5;
- the LSQ scales' gradients (``s_p``'s g counts the global batch) under
  data parallelism equal the single device's at 1e-5;
- FSDP plus TP leaves each rank a quarter of every embed x (heads | mlp)
  weight and of its moments;
- ``build_cell``'s placements (in and out) equal the reference's on every
  arch x {train_4k, decode_32k} x {zero1 off, on}, at reduced size on the
  (2, 2) mesh, from shape records alone;
- checkpoints: the reference's, written on four devices, restored by the
  port on 2 ranks and on 1; the port's four ranks' restored by the
  reference with ``shardings=`` and by the port on 2 ranks and on 1, each
  equal to the tree that was written;
- ``Cell.lower`` raises, naming ROADMAP item 13.
"""
import contextlib
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_fsdp_ranks as F
import _torch_mesh_ranks as R
from _torch_lm_train import assert_tree_close
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.core.cim_linear import CIMConfig as JCIMConfig
from repro.data.pipeline import make_lm_pipeline as j_lm_pipeline
from repro.models.registry import get_model as j_get_model
from repro.nn import init_params as j_init_params
from repro_torch import tree_map
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import MeshShape
from repro_torch.nn.module import is_placements

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SHAPES = ("train_4k", "decode_32k")

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys, time
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint import ckpt
    from repro.configs.base import RunConfig
    from repro.configs.registry import ARCHS
    from repro.core.cim_linear import CIMConfig
    from repro.launch.cells import build_cell
    from repro.models.registry import get_model
    from repro.train.trainer import make_train_step
    assert len(jax.devices()) == 4
    d = sys.argv[1]
    with open(d + "/inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    # GSPMD's auto axes: jax.make_mesh's default (explicit axes) fails the
    # reference's FSDP embedding gather (ROADMAP queue 3, fault 20)
    mesh = jax.make_mesh(*inp["mesh"],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    npy = lambda t: jax.tree.map(np.asarray, t)
    out = {"steps": {}, "cells": {}}

    def jcell(arch, cim, fsdp):
        return build_cell(arch, "train_4k", mesh, reduced=True,
                          cim=None if cim is None else CIMConfig(**cim),
                          overrides=dict(compute_dtype="float32",
                                         remat=False),
                          run_overrides=dict(fsdp=fsdp, accum_steps=1))

    for name, c in inp["cases"].items():
        cell = jcell(c["arch"], c["cim"], c["fsdp"])
        model = get_model(cell.cfg)
        init_state, step = make_train_step(
            model, cell.cfg, RunConfig(fsdp=c["fsdp"], **inp["run"]))
        params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]),
                                cell.in_shardings[0])
        state = jax.jit(init_state, out_shardings=cell.in_shardings[1])(
            params)
        batch = jax.device_put({"tokens": jnp.asarray(c["tokens"])},
                               cell.in_shardings[2])
        p, s, m = jax.jit(step, in_shardings=cell.in_shardings)(
            params, state, batch)
        out["steps"][name] = dict(loss=float(m["loss"]), params=npy(p),
                                  m=npy(s["m"]), v=npy(s["v"]))
        if name == inp["ckpt_case"]:
            tree = {"params": p, "opt_state": s}
            ckpt.save(d + "/ref_ckpt", 1, tree)
            open(d + "/ref_ckpt.done", "w").close()
            t0 = time.monotonic()
            while not os.path.exists(d + "/port_ckpt.done"):
                assert time.monotonic() - t0 < 150, "no port checkpoint"
                time.sleep(0.2)
            sh = {"params": cell.in_shardings[0],
                  "opt_state": cell.in_shardings[1]}
            back = ckpt.restore(d + "/port_ckpt", tree, shardings=sh)
            same = jax.tree.map(lambda x, s: x.sharding.is_equivalent_to(
                s, x.ndim), back, sh)
            out["port_ckpt"] = dict(tree=npy(back), placed=all(
                jax.tree.leaves(same)))

    for arch in sorted(ARCHS):
        for shape in ("train_4k", "decode_32k"):
            for zero1 in (False, True):
                cell = build_cell(arch, shape, mesh, reduced=True,
                                  run_overrides={"zero1": zero1})
                flat = jax.tree_util.tree_flatten_with_path(
                    (cell.in_shardings, cell.out_shardings),
                    is_leaf=lambda s: isinstance(s, jax.sharding.Sharding))
                out["cells"][(arch, shape, zero1)] = {
                    "".join("/" + str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path): tuple(s.spec)
                    for path, s in flat[0]}
    with open(d + "/reference.pkl", "wb") as f:
        pickle.dump(out, f)
""")


def _npy(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """Each case's params (the JAX package's init, seed 0) and batch (the
    JAX package's LM stream, 4 x 17 tokens)."""
    cases = {}
    for name, (arch, cim, fsdp) in F.CASES.items():
        cfg = j_get_config(arch, reduced=True,
                           cim=None if cim is None else JCIMConfig(**cim))
        params = _npy(jax.jit(lambda k: j_init_params(
            j_get_model(cfg).specs(cfg), k))(jax.random.PRNGKey(0)))
        tokens = np.asarray(next(j_lm_pipeline(
            vocab=cfg.vocab, seq_len=F.T, global_batch=F.B))["tokens"])
        cases[name] = dict(name=name, arch=arch, cim=cim, fsdp=fsdp,
                           params=params, tokens=tokens)
    return {"cases": cases, "run": F.RUN, "mesh": F.MESH,
            "ckpt_case": F.CKPT_CASE}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's ranks' results, the reference's)."""
    out = tmp_path_factory.mktemp("fsdp")
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(out)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    with contextlib.ExitStack() as stack:
        stack.callback(lambda: ref.poll() is None and ref.kill())
        ranks = R.run_ranks(F.body, WORLD, str(out), timeout_s=240)
        log = ref.communicate(timeout=240)[0]
    assert ref.returncode == 0, log[-3000:]
    with open(out / "reference.pkl", "rb") as f:
        reference = pickle.load(f)
    return ranks, reference


def _step_close(got, want, g_got, g_want, rel, lr=F.RUN["lr"], eps=1e-8,
                path=""):
    """Params after one AdamW step: within ``rel`` of each leaf's largest
    magnitude plus, per element, lr * min(2, 2 |dg| / (|g| + eps)), the
    most the gradients' difference dg moves the first update
    (``_torch_lm_train._assert_step_close`` at tolerance ``rel``)."""
    if isinstance(want, dict):
        for k in want:
            _step_close(got[k], want[k], g_got[k], g_want[k], rel, lr, eps,
                        f"{path}/{k}")
        return
    w = np.asarray(want, np.float32)
    g = np.asarray(got.detach().to(torch.float32) if isinstance(
        got, torch.Tensor) else got, np.float32)
    gw = np.asarray(g_want.detach().to(torch.float32) if isinstance(
        g_want, torch.Tensor) else g_want, np.float32)
    gg = g_got.detach().to(torch.float32).numpy()
    lim = (rel * float(np.abs(w).max(initial=0.0))
           + lr * np.minimum(2.0, 2.0 * np.abs(gg - gw) / (np.abs(gw) + eps)))
    assert np.all(np.abs(g - w) <= lim), (path, float(np.abs(g - w).max()))


def _grads(m):
    """The clipped gradient of a first step, from its first moment."""
    return tree_map(lambda x: x / 0.1, m)


@pytest.mark.parametrize("case", list(F.CASES))
def test_mesh_step_matches_the_reference(runs, case):
    ranks, ref = runs
    want = ref["steps"][case]
    for res in ranks:
        got = res["steps"][case]["mesh"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert_tree_close(got["m"], want["m"], rel=1e-4)
        assert_tree_close(got["v"], want["v"], rel=1e-4)
        _step_close(got["params"], want["params"], _grads(got["m"]),
                    tree_map(lambda x: np.asarray(x) / 0.1, want["m"]), 1e-4)


@pytest.mark.parametrize("case", list(F.CASES))
def test_mesh_step_equals_one_device(runs, case):
    ranks, _ = runs
    for res in ranks:
        r = res["steps"][case]
        one, got = r["single"], r["mesh"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        assert got["loss"] == ranks[0]["steps"][case]["mesh"]["loss"]
        assert_tree_close(got["m"], one["m"], rel=1e-5)
        assert_tree_close(got["v"], one["v"], rel=1e-5)
        _step_close(got["params"], one["params"], _grads(got["m"]),
                    _grads(one["m"]), 1e-5)


def test_lsq_scale_gradients_under_data_parallelism_equal_one_device(runs):
    """LSQ's g = 1 / sqrt(n q_p) counts the global batch's rows (n for
    ``s_p`` is the rows, for ``s_a`` the rows times K): with each data rank
    counting its own rows, ``s_p``'s and ``s_a``'s gradients would be off
    by sqrt(2)."""
    ranks, _ = runs
    for res in ranks:
        r = res["steps"]["llama3_fsdp_cim"]
        single, mesh = r["scales_single"], r["scales_mesh"]
        assert set(single) == set(mesh) and any(
            p.endswith("/s_p") for p in single)
        for path, want in single.items():
            got, w = mesh[path], want.numpy()
            err = float(np.abs(got.numpy() - w).max())
            assert err <= 1e-5 * float(np.abs(w).max()), (path, err)


def test_fsdp_and_tensor_parallelism_leave_a_quarter_a_rank(runs):
    ranks, _ = runs
    for res in ranks:
        blocks = res["steps"]["llama3_fsdp"]["blocks"]
        for kind in ("params", "m", "v"):
            for node in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                         "mlp/wg", "mlp/wu", "mlp/wd"):
                shape, local = blocks[f"/{kind}/layers/{node}/w"]
                assert np.prod(local) * 4 == np.prod(shape), (kind, node)
            shape, local = blocks[f"/{kind}/embed"]
            assert np.prod(local) * 4 == np.prod(shape), kind


def _pairs(spec, axes=("data", "model")):
    """(kind, dim) per mesh dim of a mesh-axis tuple."""
    out = []
    for name in axes:
        dim = next((i for i, e in enumerate(spec) if e == name or (
            isinstance(e, tuple) and name in e)), None)
        out.append(("R", None) if dim is None else ("S", dim))
    return tuple(out)


def _flat(tree, leaf, path=""):
    if leaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, leaf, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_build_cell_placements_match_the_reference(runs, arch, shape,
                                                   zero1):
    _, ref = runs
    cell = build_cell(arch, shape, MeshShape(*F.MESH), reduced=True,
                      run_overrides={"zero1": zero1})
    got = {p: tuple(("S", x.dim) if x.is_shard() else ("R", None)
                    for x in pl)
           for p, pl in _flat((cell.in_shardings, cell.out_shardings),
                              is_placements).items()}
    want = {p: _pairs(s) for p, s in ref["cells"][(arch, shape,
                                                   zero1)].items()}
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    assert got == want
    structs = _flat(cell.arg_structs, lambda x: isinstance(x, torch.Tensor))
    assert structs and all(x.device.type == "meta"
                           for x in structs.values())


def _equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
        return
    g = got.detach() if isinstance(got, torch.Tensor) else got
    assert np.array_equal(np.asarray(g), np.asarray(want)), path


def test_reference_checkpoint_restores_on_two_ranks_and_on_one(runs):
    ranks, ref = runs
    want = ref["steps"][F.CKPT_CASE]
    for res in ranks:
        got = res["ckpt"]["ref_ckpt"]
        for tree in (got["two"], got["one"]):
            _equal(tree["params"], want["params"])
            _equal(tree["opt_state"]["m"], want["m"])
            _equal(tree["opt_state"]["v"], want["v"])
        # wq (embed 64 x heads 64) over the pair's 2 ranks: its columns
        assert got["wq_block"] == (2, 64, 32), got["wq_block"]


def test_port_checkpoint_restores_in_the_reference_and_on_two_ranks_and_one(
        runs):
    ranks, ref = runs
    written = ranks[0]["steps"][F.CKPT_CASE]["mesh"]
    want = {"params": written["params"],
            "opt_state": {"m": written["m"], "v": written["v"]}}
    assert ref["port_ckpt"]["placed"]
    back = ref["port_ckpt"]["tree"]
    _equal({"params": back["params"], "opt_state": {
        k: back["opt_state"][k] for k in ("m", "v")}}, tree_map(
        lambda x: x.numpy(), want))
    assert int(back["opt_state"]["step"]) == 1
    for res in ranks:
        got = res["ckpt"]["port_ckpt"]
        for tree in (got["two"], got["one"]):
            _equal(tree["params"], want["params"])
            _equal({k: tree["opt_state"][k] for k in ("m", "v")},
                   want["opt_state"])


def test_cell_lower_names_run_cell():
    cell = build_cell("qwen3-0.6b", "decode_32k", MeshShape(*F.MESH),
                      reduced=True)
    with pytest.raises(NotImplementedError,
                       match=r"repro_torch\.launch\.dryrun\.run_cell"):
        cell.lower()


def test_olmo_runs_on_the_ports_own_init():
    """ROADMAP fault 21: olmo's non-parametric norms are empty nodes, first
    in the spec order of the port's own init; the stack's depth is read
    past them."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    cfg = get_config("olmo-1b", reduced=True).replace(
        compute_dtype="float32")
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0, device="cpu")
    assert next(iter(params["layers"])) == "ln1" and not params[
        "layers"]["ln1"]
    logits = model.forward(params, torch.zeros((2, 5), dtype=torch.long),
                           cfg)
    assert logits.shape == (2, 5, cfg.vocab) and bool(
        torch.isfinite(logits).all())
