"""Rank bodies of ``tests/test_torch_fsdp.py`` (imports no JAX): one AdamW
step of the reduced llama3-8b under FSDP plus tensor parallelism and of
the reduced qwen3-0.6b under tensor parallelism alone, on a ``("data",
"model")`` mesh of (2, 2) gloo ranks and on one device, and checkpoints
crossing meshes and packages.

The parent writes ``inputs.pkl`` (the JAX package's params as numpy and
the numpy batch of each case) to the output directory. ``body`` runs
every case on one device (no session mesh) and on the mesh with the
placements of the port's ``launch.cells.build_cell``, and returns the
losses, the params and moments after the step (placed leaves gathered),
every rank's local block shapes and the LSQ scales' gradients. The
checkpoint case then writes the mesh's trained tree (``port_ckpt``), waits
for the reference's (``ref_ckpt``, written by the reference's subprocess on
four devices), and restores both on a ``("model",)`` mesh of 2 ranks (each
pair of ranks its own) and on one device.
"""
from __future__ import annotations

import os
import pickle
import time

import torch

CPU = "cpu"
#: tests/test_models.py::test_cim_enabled_lm_trains's CIM config: 32 x 32
#: arrays, so the reduced llama3's wo (64 rows, 32 a rank) is tile-aligned
#: per rank and its wd (160 rows, 80 a rank) is not
LM_CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
              act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
#: (arch, CIM fields or None, fsdp)
CASES = {"llama3_fsdp": ("llama3-8b", None, True),
         "llama3_fsdp_cim": ("llama3-8b", LM_CIM, True),
         "qwen3_tp": ("qwen3-0.6b", None, False)}
CKPT_CASE = "llama3_fsdp_cim"
RUN = dict(lr=1e-3, total_steps=10, warmup_steps=2)
B, T = 4, 16
MESH = ((2, 2), ("data", "model"))
WAIT_S = 150


def cell(arch, cim, fsdp, mesh):
    """The port's ``build_cell`` of a case on ``mesh``: float32 compute."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.launch.cells import build_cell
    return build_cell(arch, "train_4k", mesh, reduced=True,
                      cim=None if cim is None else CIMConfig(**cim),
                      overrides={"compute_dtype": "float32"},
                      run_overrides={"fsdp": fsdp, "accum_steps": 1})


def _full(tree):
    from repro_torch.core import colshard
    return colshard.full_tree(tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _scales(grads):
    """{path: gradient} of every LSQ scale leaf (s_w, s_p, s_a)."""
    return {p: v for p, v in _leaves(grads)
            if p.rsplit("/", 1)[-1] in ("s_w", "s_p", "s_a")}


def step_case(case, mesh):
    """One AdamW step of ``case`` on one device and on ``mesh``."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import colshard
    from repro_torch.interop import from_numpy_tree
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import place_tree, session_mesh
    from repro_torch.train.trainer import (batch_grads, lm_loss_fn,
                                           make_train_step)
    arch, cim, fsdp = CASES[case["name"]]
    c = cell(arch, cim, fsdp, mesh)
    model = get_model(c.cfg)
    params = from_numpy_tree(case["params"], CPU)
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    init_state, step = make_train_step(model, c.cfg,
                                       RunConfig(fsdp=fsdp, **RUN))
    loss_fn = lm_loss_fn(model, c.cfg)
    out = {}
    p1, s1, m1 = step(params, init_state(params), batch)
    out["single"] = dict(loss=float(m1["loss"]), params=p1,
                         m=s1["m"], v=s1["v"])
    out["scales_single"] = _scales(batch_grads(loss_fn, params, batch)[1])
    placed = place_tree(params, c.in_shardings[0], mesh)
    with session_mesh(mesh):
        state = place_tree(init_state(placed), c.in_shardings[1], mesh)
        p2, s2, m2 = step(placed, state, batch)
        out["scales_mesh"] = _full(_scales(
            batch_grads(loss_fn, placed, batch)[1]))
    out["mesh"] = dict(loss=float(m2["loss"]), params=_full(p2),
                       m=_full(s2["m"]), v=_full(s2["v"]))
    out["blocks"] = {p: (tuple(v.shape), tuple(colshard.local(v).shape))
                     for p, v in _leaves({"params": p2, "m": s2["m"],
                                          "v": s2["v"]})}
    return out, (p2, s2, c)


def _wait_for(path, what):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"{what} did not appear at {path}")
        time.sleep(0.2)


def checkpoints(trained, mesh, out_dir, rank):
    """The mesh's trained tree written as checkpoint 1 (``port_ckpt``),
    then the reference's and the port's checkpoints restored on a
    ``("model",)`` mesh of 2 ranks and on one device (trees gathered)."""
    from repro_torch.checkpoint import ckpt
    p2, s2, c = trained
    arch, cim, fsdp = CASES[CKPT_CASE]
    tree = {"params": p2, "opt_state": s2}
    port_dir = os.path.join(out_dir, "port_ckpt")
    ckpt.save(port_dir, 1, tree)              # gathered; rank 0 writes
    if rank == 0:
        open(os.path.join(out_dir, "port_ckpt.done"), "w").close()
    like = _full(tree)
    pair = mesh["model"]
    c2 = cell(arch, cim, fsdp, pair)
    sh2 = {"params": c2.in_shardings[0], "opt_state": c2.in_shardings[1]}
    _wait_for(os.path.join(out_dir, "ref_ckpt.done"), "the reference's "
              "checkpoint")
    out = {}
    for name in ("ref_ckpt", "port_ckpt"):
        d = os.path.join(out_dir, name)
        two = ckpt.restore(d, like, shardings=sh2, mesh=pair, device=CPU)
        wq = two["params"]["layers"]["attn"]["wq"]["w"]
        out[name] = dict(two=_full(two), one=ckpt.restore(d, like,
                                                          device=CPU),
                         wq_block=tuple(wq.to_local().shape),
                         wq_placements=str(wq.placements))
    return out


def body(rank, world, mesh, out_dir):
    from repro_torch.launch import mesh as lm
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    m2 = lm.make_mesh(*MESH, device=CPU, backend="gloo")
    res = {"steps": {}}
    for name, case in inputs["cases"].items():
        res["steps"][name], trained = step_case(case, m2)
        if name == CKPT_CASE:
            res["ckpt"] = checkpoints(trained, m2, out_dir, rank)
    return res


def zoo_body(rank, world, mesh, out_dir):
    """Every config of the registry at its reduced size, float32, one
    forward and backward of the LM loss on one device and on the (2, 2)
    mesh under ``build_cell``'s placements (the MoE families with
    ``moe_impl="auto"``): {arch: (loss one device, loss mesh, {leaf path:
    max |grad diff| / max |grad|})}."""
    import numpy as np

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import mesh as lm
    from repro_torch.models.registry import frontend_input_shape, get_model
    from repro_torch.nn.module import init_params, place_tree, session_mesh
    from repro_torch.train.trainer import batch_grads, lm_loss_fn
    m2 = lm.make_mesh(*MESH, device=CPU, backend="gloo")
    out = {}
    for arch in sorted(ARCHS):
        from repro_torch.launch.cells import build_cell
        c = build_cell(arch, "train_4k", m2, reduced=True, accum=1,
                       overrides={"compute_dtype": "float32",
                                  "param_dtype": "float32",
                                  "moe_impl": "auto"})
        model = get_model(c.cfg)
        params = init_params(model.specs(c.cfg), 0, device=CPU)
        rs = np.random.RandomState(1)
        batch = {"tokens": torch.from_numpy(rs.randint(
            0, c.cfg.vocab, (B, T + 1)).astype(np.int32))}
        shape = frontend_input_shape(c.cfg, B)
        if shape is not None:
            batch["frontend"] = torch.from_numpy(
                (rs.randn(*shape) * 0.1).astype(np.float32))
        loss_fn = lm_loss_fn(model, c.cfg)
        l1, g1 = batch_grads(loss_fn, params, batch)
        placed = place_tree(params, c.in_shardings[0], m2)
        with session_mesh(m2):
            l2, g2 = batch_grads(loss_fn, placed, batch)
        g2 = dict(_leaves(_full(g2)))
        errs = {p: float((g2[p] - v).abs().max())
                / max(float(v.abs().max()), 1e-30)
                for p, v in _leaves(g1)}
        out[arch] = (float(l1), float(l2), errs)
    return out
