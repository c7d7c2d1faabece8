"""Rank bodies of ``tests/test_torch_serve_cells.py`` (imports no JAX): the
serve cells of every family on a ``("data", "model")`` mesh of (2, 2)
gloo ranks, each rank stepping its rows (``launch.cells.serve_rows``).

The parent writes ``inputs.pkl`` (each case's params from the JAX
package's init as numpy, the prompt, the decode tokens and whisper's
encoder states) to the output directory. ``body`` runs every case on
this rank: the cell's step on the rank's rows, a prefill and
``DECODE_STEPS`` decode steps of given tokens, and, where flash decode is
off, the same placements stepped on the whole batch (every rank all rows,
a cache made whole) for the bit-equality; then whisper's and llava's
prefill with the front-end input beside their one-device forward.
Logits and cache rows come back gathered over ``"model"`` only: each
rank's own rows.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from _torch_mesh_ranks import CIM, CPU

MESH = ((2, 2), ("data", "model"))
#: 4 rows a data rank, prompts of 8 tokens, max_len 16, 2 decode steps.
#: On the CPU ATen's vectorized elementwise kernels round a tail of their
#: loop (under 32 floats) with the scalar version (zamba2's softplus,
#: ``torch.logaddexp``, over its 8 heads), so rows x tokens x 8 is kept a
#: multiple of 32 for the bit-equality with the whole batch's step
BATCH, PROMPT, MAX_LEN, DECODE_STEPS = 8, 8, 16, 2
SHAPE_NAME = "serve_cells_test"
#: cases: (arch, config overrides); every case computes in float32, the
#: MoE families on the reference's expert-parallel path
CASES = {
    "llama3": ("llama3-8b", {}),
    "llama3_kv8": ("llama3-8b", {"kv_cache_dtype": "int8"}),
    "llama3_flash": ("llama3-8b", {"flash_decode": True}),
    "llama3_flash_kv8": ("llama3-8b", {"flash_decode": True,
                                       "kv_cache_dtype": "int8"}),
    "qwen3": ("qwen3-0.6b", {}),
    "deepseek": ("deepseek-v3-671b", {"moe_impl": "auto"}),
    "deepseek_flash": ("deepseek-v3-671b", {"moe_impl": "auto",
                                            "flash_decode": True}),
    "moonshot": ("moonshot-v1-16b-a3b", {"moe_impl": "auto"}),
    "whisper": ("whisper-small", {}),
    "llava": ("llava-next-mistral-7b", {}),
    "zamba2": ("zamba2-2.7b", {}),
    "xlstm": ("xlstm-1.3b", {}),
}
#: the families whose serve step takes a front-end input
FRONTEND = ("whisper", "llava")


def overrides(name):
    return {"compute_dtype": "float32", **CASES[name][1]}


#: the front-end prefill's cache: llava's 16 patches before the prompt
FRONTEND_MAX_LEN = 32


def shape(max_len=MAX_LEN):
    from repro_torch.configs.base import Shape
    return Shape(SHAPE_NAME, "decode", max_len, BATCH)


def _cell(name, mesh, max_len=MAX_LEN):
    from repro_torch.launch.cells import build_cell
    return build_cell(CASES[name][0], shape(max_len), mesh, reduced=True,
                      overrides=overrides(name))


def row_dim(path):
    """The batch dim of a cache leaf (whisper's ``enc_out`` leads with
    it, every stacked leaf has it second)."""
    return 0 if path.endswith("enc_out") else 1


def _rows_of(x, axes):
    """A placed cache leaf's rows on this rank, whole in time (a
    flash-decode leaf's time gathered over ``"model"``)."""
    from repro_torch.core import colshard
    return colshard.full_leaf(colshard.rows_view(x, axes)).detach().clone()


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def _logit_rows(logits, mesh):
    """This rank's logits rows with the whole vocab (its vocab block
    gathered over ``"model"``)."""
    from repro_torch.core import colshard
    if not colshard.is_col_sharded(logits):
        return logits.detach().clone()
    loc = colshard.local(logits)
    if 2 in colshard.sharded_dims(logits):
        loc = colshard.all_gather(loc, mesh, ("model",), -1)
    return loc.detach().clone()


def _take_rows(x, mesh, axes):
    """This rank's rows of ``x`` over the batch ``axes``
    (``train.trainer._rows``, as the serve step takes them)."""
    from repro_torch.train.trainer import _rows
    return _rows({"x": x}, mesh, axes)["x"] if axes else x


def _set_enc_out(cache, enc, mesh, axes):
    """Write the encoder states (B, F, D) into the cache's ``enc_out``:
    the rank's rows of a placed leaf, or the whole leaf."""
    from repro_torch.core import colshard
    x = torch.from_numpy(enc)
    leaf = cache["enc_out"]
    if colshard.is_col_sharded(leaf):
        colshard.local(leaf).copy_(_take_rows(x, mesh, axes))
    else:
        leaf.copy_(x)


def serve_case(name, case, mesh):
    """The cell's step on this rank's rows: per call the logits rows and
    every cache leaf's rows, the collectives' ops by mesh dim of the
    steps, the cache's placements; and the whole batch's step on the
    same placements where flash decode is off."""
    from repro_torch.core import colshard
    from repro_torch.interop import from_numpy_tree
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import place_tree, session_mesh
    cell = _cell(name, mesh)
    cfg, model = cell.cfg, get_model(cell.cfg)
    axes = ("data",)
    params = place_tree(from_numpy_tree(case["params"], CPU),
                        cell.in_shardings[0], mesh)
    tokens = [torch.from_numpy(t) for t in case["tokens"]]
    res = {"calls": [], "axes": {}}
    with session_mesh(mesh, cell.rules):
        cache = model.init_cache(cfg, BATCH, MAX_LEN, device=CPU)
        if "enc_out" in cache:
            _set_enc_out(cache, case["enc_out"], mesh, axes)
        res["placed"] = {p: (type(v).__name__, tuple(v.shape),
                             tuple(colshard.local(v).shape))
                         for p, v in _flat(cache)}
        for t in tokens:
            colshard.reset_collective_counts()
            logits, cache = cell.step_fn(params, cache, t)
            for kind, by in colshard.collective.axes.items():
                for a, n in by.items():
                    res["axes"][(kind, a)] = res["axes"].get((kind, a),
                                                             0) + n
            res["logits_placed"] = (type(logits).__name__,
                                    tuple(logits.shape),
                                    tuple(colshard.local(logits).shape))
            res["calls"].append((_logit_rows(logits, mesh),
                                 {p: _rows_of(v, axes)
                                  for p, v in _flat(cache)}))
        try:
            model.decode_step(params, cache, tokens[-1], cfg)
            res["refused"] = None
        except ValueError as e:
            res["refused"] = str(e)
        if not cfg.flash_decode:
            res["whole"] = _whole_batch(model, cfg, params, case, tokens,
                                        mesh)
    return res


def _rows_whole(x, path):
    """A cache leaf as the whole batch's step holds it under the same
    mesh: its rows gathered over ``"data"``, its time or heads over
    ``"model"`` kept."""
    from repro_torch.core import colshard
    if not colshard.is_col_sharded(x):
        return x
    dims, mesh, rd = colshard.sharded_dims(x), x.device_mesh, row_dim(path)
    loc = colshard.local(x)
    if rd in dims:
        loc = colshard.all_gather(loc, mesh, ("data",), rd)
    keep = {d: ax for d, ax in dims.items() if d != rd}
    if not keep:
        return loc
    return colshard.placed(loc, mesh, colshard.placements_of(mesh, keep),
                           tuple(x.shape))


def _whole_batch(model, cfg, params, case, tokens, mesh):
    """The same steps on the whole batch on every rank (the cache's rows
    whole, its time and heads over ``"model"`` as ``init_cache`` places
    them): this rank's rows of each call's logits and cache."""
    from repro_torch.core import colshard
    cache = model.init_cache(cfg, BATCH, MAX_LEN, device=CPU)
    cache = _map_paths(_rows_whole, cache)
    if "enc_out" in cache:
        _set_enc_out(cache, case["enc_out"], mesh, ())
    out = []
    for t in tokens:
        logits, cache = model.decode_step(params, cache, t, cfg)
        rows = {p: _take_rows(colshard.full_leaf(v).transpose(
                    0, row_dim(p)), mesh, ("data",)).transpose(0, row_dim(p))
                for p, v in _flat(cache)}
        out.append((_take_rows(logits, mesh, ("data",)).detach().clone(),
                    {p: v.detach().clone() for p, v in rows.items()}))
    return out


def _map_paths(fn, tree, path=""):
    """``fn(leaf, path)`` over a cache tree, ``_flat``'s paths."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return fn(tree, path)


def frontend_case(name, case, mesh):
    """(the rank's rows of the data parallel prefill with the front-end
    input, the one-device forward's logits on the whole batch)."""
    from repro_torch.interop import from_numpy_tree
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import place_tree, session_mesh
    cell = _cell(name, mesh, FRONTEND_MAX_LEN)
    cfg, model = cell.cfg, get_model(cell.cfg)
    whole = from_numpy_tree(case["params"], CPU)
    params = place_tree(whole, cell.in_shardings[0], mesh)
    tokens = torch.from_numpy(case["tokens"][0])
    frontend = torch.from_numpy(case["frontend"])
    with session_mesh(mesh, cell.rules):
        cache = model.init_cache(cfg, BATCH, FRONTEND_MAX_LEN, device=CPU)
        logits, _ = cell.step_fn(params, cache, tokens, frontend)
        rows = _logit_rows(logits, mesh)
    one = model.forward(whole, tokens, cfg, frontend)
    return rows, _take_rows(one, mesh, ("data",)).detach().clone()


def adc_case(mesh):
    """The ADC collector's (saturated, conversions) over one prefill of the
    reduced llama3 under CIM emulate (the port's init, 32 x 32 arrays,
    every partial-sum scale narrowed 50x so that conversions clip): on one
    device, and over the data parallel serve step under the mesh."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.launch.cells import build_cell
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, place_tree, session_mesh
    from repro_torch.obs import adc
    cell = build_cell("llama3-8b", shape(), mesh, reduced=True,
                      cim=CIMConfig(**CIM), overrides=overrides("llama3"))
    cfg, model = cell.cfg, get_model(cell.cfg)
    params = _narrow(init_params(model.specs(cfg), 0, device=CPU))
    tokens = torch.from_numpy(numpy_tokens(cfg.vocab, 7)[0])
    with adc.sampled():
        model.decode_step(params, model.init_cache(cfg, BATCH, MAX_LEN,
                                                   device=CPU), tokens, cfg)
        one = adc.totals()
    placed = place_tree(params, cell.in_shardings[0], mesh)
    with session_mesh(mesh, cell.rules), adc.sampled():
        cache = model.init_cache(cfg, BATCH, MAX_LEN, device=CPU)
        cell.step_fn(placed, cache, tokens)
        rows = adc.totals()
    return one, rows


def adc_mla_case(mesh):
    """The ADC collector's (saturated, conversions) over a prefill and one
    decode step of the reduced deepseek-v3 under CIM emulate with flash
    decode (the sequence-parallel MLA decode: each rank's time block
    through every column of ``wkv_b``; the expert-parallel MoE), the
    partial-sum scales narrowed as in ``adc_case``: on one device, and
    over the serve cell's step under the mesh."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.launch.cells import build_cell
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, place_tree, session_mesh
    from repro_torch.obs import adc
    cell = build_cell("deepseek-v3-671b", shape(), mesh, reduced=True,
                      cim=CIMConfig(**CIM),
                      overrides=overrides("deepseek_flash"))
    cfg, model = cell.cfg, get_model(cell.cfg)
    params = _narrow(init_params(model.specs(cfg), 0, device=CPU))
    tokens = [torch.from_numpy(t) for t in numpy_tokens(cfg.vocab, 8)[:2]]
    with adc.sampled():
        cache = model.init_cache(cfg, BATCH, MAX_LEN, device=CPU)
        for t in tokens:
            _, cache = model.decode_step(params, cache, t, cfg)
        one = adc.totals()
    placed = place_tree(params, cell.in_shardings[0], mesh)
    with session_mesh(mesh, cell.rules), adc.sampled():
        cache = model.init_cache(cfg, BATCH, MAX_LEN, device=CPU)
        for t in tokens:
            _, cache = cell.step_fn(placed, cache, t)
        rows = adc.totals()
    return one, rows


def _narrow(tree):
    """Every partial-sum scale of a param tree narrowed 50x (conversions
    clip)."""
    if isinstance(tree, dict):
        return {k: (v / 50 if k.endswith("s_p") else _narrow(v))
                for k, v in tree.items()}
    return tree


def body(rank, world, _mesh, out_dir):
    from repro_torch.launch import mesh as lm
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = lm.make_mesh(*MESH, device=CPU, backend="gloo")
    res = {"serve": {n: serve_case(n, c, mesh)
                     for n, c in inputs["cases"].items()}}
    res["frontend"] = {n: frontend_case(n, inputs["cases"][n], mesh)
                       for n in FRONTEND}
    res["adc"] = adc_case(mesh)
    res["adc_mla"] = adc_mla_case(mesh)
    res["rows"] = int(mesh.get_local_rank(mesh_dim="data"))
    return res


def numpy_tokens(vocab, seed):
    """The prompt (B, PROMPT) and the decode steps' tokens (B, 1)."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (BATCH, PROMPT)).astype(np.int32)] + [
        rs.randint(0, vocab, (BATCH, 1)).astype(np.int32)
        for _ in range(DECODE_STEPS)]
