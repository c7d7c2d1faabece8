"""Rank bodies of ``tests/test_torch_parallel_layers.py`` (imports no JAX):
the expert-parallel MoE, the sequence-parallel flash decode, their
engine, AdamW step and ADC totals, and ``shard_params``' placements of
every config, on gloo ranks.

The parent writes ``inputs.pkl`` (the JAX package's params as numpy, and
the numpy inputs) to the output directory; ``body`` runs every case on
this rank under the ``("model",)`` mesh of ``run_ranks`` and a ``("data",
"model")`` mesh of the same ranks, and on one device (no session mesh),
and returns what the cases compare. Sharded leaves come back gathered.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from _torch_mesh_ranks import CIM, CPU

MOE_ARCH, LM_ARCH = "moonshot-v1-16b-a3b", "llama3-8b"
#: the mesh of each case: (shape, dim names)
MESHES = {"model4": ((4,), ("model",)), "data2_model2": ((2, 2),
                                                         ("data", "model"))}
#: MoE block cases: (mesh, CIM config or None, batch, tokens, MoEConfig
#: fields). ep4_drop's capacity factor leaves experts full, so tokens drop;
#: jit6's six experts do not divide four ranks: the jit path
MOE_CASES = {
    "ep4": ("model4", None, 2, 8, {}),
    "ep22": ("data2_model2", None, 2, 8, {}),
    "ep4_cim": ("model4", CIM, 2, 8, {}),
    "ep4_drop": ("model4", None, 4, 40, {"capacity_factor": 0.5}),
    "jit6": ("model4", None, 2, 8, {"n_experts": 6}),
}
#: flash-decode cases: (mesh, KV cache dtype); the reduced llama3 in
#: float32, batch 4, prompts of 8 tokens, max_len 32, 5 decode steps
FD_CASES = {"fd_bf16": ("model4", "bf16"), "fd_int8": ("model4", "int8"),
            "fd_bf16_22": ("data2_model2", "bf16")}
FD_BATCH, FD_PROMPT, FD_MAX_LEN, FD_STEPS = 4, 8, 32, 5
#: the AdamW step's run (clipping on: the gradient norm is above 0.05)
RUN = dict(lr=1e-3, total_steps=10, warmup_steps=2, grad_clip=0.05)


def moe_cfg(cim=None, **moe):
    """The reduced moonshot in float32 with ``moe_impl="ep"``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cim_linear import CIMConfig
    cfg = get_config(MOE_ARCH, reduced=True,
                     cim=None if cim is None else CIMConfig(**cim)).replace(
        compute_dtype="float32", remat=False, moe_impl="ep")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


def fd_cfg(kv: str):
    from repro_torch.configs.registry import get_config
    return get_config(LM_ARCH, reduced=True).replace(
        compute_dtype="float32", attn_chunk=0, flash_decode=True,
        kv_cache_dtype=kv)


def _meshes(world, mesh):
    from repro_torch.launch import mesh as lm
    return {"model4": mesh,
            "data2_model2": lm.make_mesh((2, world // 2), ("data", "model"),
                                         device=CPU, backend="gloo")}


def _full(tree):
    from repro_torch.core import colshard
    return colshard.full_tree(tree)


def _counting(module, name):
    """Count the calls of ``module.name``: (counts, undo)."""
    orig = getattr(module, name)
    counts = {"calls": 0}

    def wrapped(*a, **kw):
        counts["calls"] += 1
        return orig(*a, **kw)
    setattr(module, name, wrapped)
    return counts, lambda: setattr(module, name, orig)


def _moe_run(p, x, proj, cfg):
    """(y, loss, param grads, input grad) of sum(apply_moe(p, x) * proj)."""
    from repro_torch.models import layers
    from repro_torch.train.trainer import loss_and_grads

    def loss_fn(tree, _):
        return torch.sum(layers.apply_moe(tree["p"], tree["x"], cfg) * proj)
    loss, g = loss_and_grads(loss_fn, {"p": p, "x": x}, None)
    with torch.no_grad():
        y = layers.apply_moe(p, x, cfg)
    return y, loss, _full(g["p"]), g["x"]


def moe_case(case, meshes):
    from repro_torch.core import colshard
    from repro_torch.interop import from_numpy_tree
    from repro_torch.launch.mesh import expert_parallel_rules
    from repro_torch.models import layers
    from repro_torch.nn.module import session_mesh, shard_params
    mesh_name, cim, _, _, moe = MOE_CASES[case["name"]]
    cfg = moe_cfg(cim, **moe)
    mesh = meshes[mesh_name]
    p = from_numpy_tree(case["params"], CPU)
    x, proj = torch.from_numpy(case["x"]), torch.from_numpy(case["proj"])
    res = {"single": _moe_run(p, x, proj, cfg)}
    placed = p
    if cfg.moe.n_experts % colshard.mesh_shards(mesh, "model") == 0:
        placed = shard_params(p, layers.moe_specs(cfg), mesh,
                              expert_parallel_rules(mesh))
    counts, undo = _counting(layers, "_apply_moe_ep")
    calls = colshard.collective.calls
    try:
        with session_mesh(mesh):
            res["mesh"] = _moe_run(placed, x, proj, cfg)
    finally:
        undo()
    res["ep_calls"] = counts["calls"]
    res["collectives"] = colshard.collective.calls - calls
    res["bank"] = (type(placed["wg"]).__name__,
                   tuple(colshard.local(placed["wg"]).shape))
    return res


def _greedy(logits):
    return torch.argmax(logits[:, -1].to(torch.float32), dim=-1)[:, None].to(
        torch.int32)


def _rows_step(model, cfg):
    """The data parallel serve step (``launch.cells.serve_rows``: each
    rank on its rows and cache rows), its logits gathered whole."""
    from repro_torch.core import colshard
    from repro_torch.launch.cells import serve_rows

    def step(params, cache, tokens, _cfg):
        logits, cache = serve_rows(model, cfg, params, cache, tokens)
        return colshard.full_leaf(logits), cache
    return step


def _fd_run(model, params, cfg, prompts, step=None):
    """Prefill and ``FD_STEPS`` greedy decode steps of ``step`` (the
    model's ``decode_step`` when None): (logits per call, tokens (B, 1 +
    FD_STEPS), the cache)."""
    step = step or model.decode_step
    cache = model.init_cache(cfg, FD_BATCH, FD_MAX_LEN, device=CPU)
    logits, cache = step(params, cache, prompts, cfg)
    out, toks = [logits], [_greedy(logits)]
    for _ in range(FD_STEPS):
        logits, cache = step(params, cache, toks[-1], cfg)
        out.append(logits)
        toks.append(_greedy(logits))
    return out, torch.cat(toks, dim=1), cache


def fd_case(case, meshes):
    from repro_torch.core import colshard
    from repro_torch.interop import from_numpy_tree
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import session_mesh
    from repro_torch.serve.engine import ServingEngine
    mesh_name, kv = FD_CASES[case["name"]]
    cfg = fd_cfg(kv)
    model = get_model(cfg)
    params = from_numpy_tree(case["params"], CPU)
    prompts = torch.from_numpy(case["prompts"])
    res = {"single": _fd_run(model, params, cfg, prompts)[:2]}
    mesh = meshes[mesh_name]
    # on the (data, model) mesh the cache holds its rows over "data": the
    # serve cell's step runs each rank on its rows
    step = _rows_step(model, cfg) if "data" in MESHES[mesh_name][1] else None
    with session_mesh(mesh):
        calls = colshard.collective.calls
        logits, toks, cache = _fd_run(model, params, cfg, prompts, step)
        res["collectives"] = colshard.collective.calls - calls
        res["mesh"] = (logits, toks)
        res["cache"] = {n: (type(v).__name__, tuple(v.shape),
                            tuple(colshard.local(v).shape))
                        for n, v in cache["layers"].items()}
        if case["name"] == "fd_bf16":
            eng = ServingEngine(model, cfg, params, batch_size=FD_BATCH,
                                max_len=FD_MAX_LEN, device=CPU)
            res["engine"] = eng.generate_batch(case["prompts"], FD_STEPS + 1)
    return res


#: the other families whose decode reaches gqa_attend, reduced, flash
#: decode under the model mesh against their single device
FD_ZOO = ("zamba2-2.7b", "whisper-small")


def fd_zoo_case(arch, mesh):
    """(single device, mesh): logits of a prefill and ``FD_STEPS`` steps,
    the tokens, and the mesh's cache placement."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, session_mesh
    cfg = get_config(arch, reduced=True).replace(compute_dtype="float32",
                                                 flash_decode=True)
    model = get_model(cfg)
    params = init_params(model.specs(cfg), 0, device=CPU)
    prompts = torch.from_numpy(np.random.RandomState(9).randint(
        0, cfg.vocab, (FD_BATCH, FD_PROMPT)).astype(np.int32))
    single = _fd_run(model, params, cfg, prompts)[:2]
    with session_mesh(mesh):
        logits, toks, cache = _fd_run(model, params, cfg, prompts)
    k = (cache["attn"] if "attn" in cache else cache)["k"]
    return single, (logits, toks), type(k).__name__


def engine_artifact_case(mesh):
    """The reduced llama3 packed by the port (32x32 arrays, the plain
    path), served by ``engine_from_artifact`` with flash decode: on one
    device, and column-sharded with a time-sharded cache under ``mesh``."""
    from repro_torch import api
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, session_mesh
    from repro_torch.serve.engine import engine_from_artifact
    cim = CIMConfig(**CIM, use_kernel=False)
    cfg = get_config(LM_ARCH, reduced=True, cim=cim).replace(
        compute_dtype="float32", flash_decode=True)
    art = api.model_artifact(init_params(get_model(cfg).specs(cfg), 0,
                                         device=CPU), cim, device=CPU)
    prompts = np.random.RandomState(7).randint(0, cfg.vocab, (4, 8)).astype(
        np.int32)
    single = engine_from_artifact(art, cfg, batch_size=4, max_len=32,
                                  device=CPU).generate_batch(prompts, 6)
    with session_mesh(None):
        eng = engine_from_artifact(art, cfg, mesh=mesh, batch_size=4,
                                   max_len=32, device=CPU)
        tokens = eng.generate_batch(prompts, 6)
        placed = type(eng.cache["layers"]["k"]).__name__
    return single, tokens, placed


def adamw_case(mesh):
    """One AdamW step of the reduced moonshot (CIM emulate on the model
    mesh, off on the 2-D one) on one device and on the mesh with the
    expert banks placed: (loss, grad norm, params, moments) each, sharded
    leaves gathered, and the placed leaves' names."""
    from repro_torch import tree_map
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import colshard
    from repro_torch.launch.mesh import expert_parallel_rules
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, session_mesh, shard_params
    from repro_torch.train.trainer import make_train_step
    two_d = "data" in mesh.mesh_dim_names
    cfg = moe_cfg(None if two_d else CIM)
    model = get_model(cfg)
    specs = model.specs(cfg)
    params = init_params(specs, 0, device=CPU)
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    init_state, step = make_train_step(model, cfg, RunConfig(**RUN))

    def run(p):
        new, state, m = step(p, init_state(p), {"tokens": tokens})
        moments = {k: _full(tree_map(colshard.like, p, state[k]))
                   for k in ("m", "v")}
        return (float(m["loss"]), float(m["grad_norm"]), _full(new),
                moments)
    res = {"single": run(params)}
    placed = shard_params(params, specs, mesh, expert_parallel_rules(mesh))
    res["placed"] = sorted(
        path for path, v in _leaves(placed) if colshard.is_col_sharded(v))
    with session_mesh(mesh):
        res["mesh"] = run(placed)
    return res


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def adc_case(case, mesh):
    """The MoE block under CIM emulate with the collector armed: its
    totals on one device (the jit path) and over the mesh (expert
    parallel, the banks placed)."""
    from repro_torch.interop import from_numpy_tree
    from repro_torch.launch.mesh import expert_parallel_rules
    from repro_torch.models import layers
    from repro_torch.nn.module import session_mesh, shard_params
    from repro_torch.obs import adc
    cfg = moe_cfg(CIM)
    p = from_numpy_tree(case["params"], CPU)
    x = torch.from_numpy(case["x"])
    out = {}
    with adc.sampled():
        layers.apply_moe(p, x, cfg)
        out["single"] = adc.totals()
    placed = shard_params(p, layers.moe_specs(cfg), mesh,
                          expert_parallel_rules(mesh))
    with session_mesh(mesh), adc.sampled():
        layers.apply_moe(placed, x, cfg)
        out["mesh"] = adc.totals()
    return out


def placements(meshes):
    """Every config's reduced tree (the port's init) placed by
    ``shard_params`` under the full ``sharding_rules`` of the (2, 2) mesh,
    FSDP as the arch's ``RUN_HINTS`` say: {arch: {leaf path: (global
    shape, local shape, placements as (kind, dim) pairs)}}."""
    from repro_torch.configs.registry import ARCHS, get_config
    from repro_torch.core import colshard
    from repro_torch.launch.cells import RUN_HINTS
    from repro_torch.launch.mesh import sharding_rules
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, shard_params
    mesh = meshes["data2_model2"]
    out = {}
    for arch in sorted(ARCHS):
        cfg = get_config(arch, reduced=True)
        specs = get_model(cfg).specs(cfg)
        placed = shard_params(init_params(specs, 0, device=CPU), specs, mesh,
                              sharding_rules(mesh, fsdp=RUN_HINTS[arch][
                                  "fsdp"]))
        out[arch] = {
            path: (tuple(v.shape), tuple(colshard.local(v).shape),
                   tuple(("S", p.dim) if p.is_shard() else ("R", None)
                         for p in v.placements)
                   if colshard.is_col_sharded(v) else None)
            for path, v in _leaves(placed)}
    return out


def body(rank, world, mesh, out_dir):
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    meshes = _meshes(world, mesh)
    res = {"moe": {n: moe_case(c, meshes) for n, c in inputs["moe"].items()},
           "fd": {n: fd_case(c, meshes) for n, c in inputs["fd"].items()}}
    res["fd_zoo"] = {a: fd_zoo_case(a, mesh) for a in FD_ZOO}
    res["engine_artifact"] = engine_artifact_case(mesh)
    res["adamw"] = {n: adamw_case(m) for n, m in meshes.items()}
    res["adc"] = adc_case(inputs["adc"], mesh)
    res["placements"] = placements(meshes)
    return res


def cuda_body(rank, world, mesh, out_dir):
    """The expert-parallel MoE block (forward and gradients) and flash
    decode with both caches on ``world`` gloo ranks sharing one card,
    each beside the single device's, the port's own params and inputs."""
    from repro_torch.core import colshard
    from repro_torch.launch.mesh import expert_parallel_rules
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, session_mesh, shard_params
    dev = torch.device(mesh.device_type, torch.cuda.current_device())
    res = {}
    cfg = moe_cfg(CIM)
    p = init_params(layers.moe_specs(cfg), 1, device=dev)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, cfg.d_model), generator=g).to(dev)
    proj = torch.randn((2, 8, cfg.d_model), generator=g).to(dev)
    single = _moe_run(p, x, proj, cfg)
    placed = shard_params(p, layers.moe_specs(cfg), mesh,
                          expert_parallel_rules(mesh))
    with session_mesh(mesh):
        sharded = _moe_run(placed, x, proj, cfg)
    res["moe"] = tuple(_cpu(t) for t in (single, sharded))
    for kv in ("bf16", "int8"):
        fcfg = fd_cfg(kv)
        model = get_model(fcfg)
        params = init_params(model.specs(fcfg), 0, device=dev)
        prompts = torch.from_numpy(np.random.RandomState(5).randint(
            0, fcfg.vocab, (FD_BATCH, FD_PROMPT)).astype(np.int32)).to(dev)

        def run():
            cache = model.init_cache(fcfg, FD_BATCH, FD_MAX_LEN, device=dev)
            logits, cache = model.decode_step(params, cache, prompts, fcfg)
            out, toks = [logits], [_greedy(logits)]
            for _ in range(FD_STEPS):
                logits, cache = model.decode_step(params, cache, toks[-1],
                                                  fcfg)
                out.append(logits)
                toks.append(_greedy(logits))
            return (_cpu(out), torch.cat(toks, dim=1).cpu(),
                    type(cache["layers"]["k"]).__name__,
                    tuple(colshard.local(cache["layers"]["k"]).shape))
        one = run()
        with session_mesh(mesh):
            res[f"fd_{kv}"] = (one, run())
    return res


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree
