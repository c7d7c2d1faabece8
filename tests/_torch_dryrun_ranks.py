"""Rank body of ``tests/test_torch_account.py`` (imports no JAX): the
reduced steps that the dry run counts on ``meta`` tensors under the fake
process group, run for real on a ``("data", "model")`` mesh of (2, 2) gloo
ranks on the CPU, each rank counting its collectives by kind
(``core.colshard.collective``) over one step and the bytes of the
arguments it holds.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import torch

CPU = "cpu"
MESH = ((2, 2), ("data", "model"))
#: 32 x 32 arrays: the reduced llama3's row-parallel wd is split mid-tile
LM_CIM = dict(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
              act_bits=8, psum_bits=6, array_rows=32, array_cols=32)
B, T = 8, 16
#: name -> (arch, shape name, CIM fields or None, config overrides)
CASES = {
    "llama3_train_cim": ("llama3-8b", "train_4k", LM_CIM, None),
    "moonshot_train_ep": ("moonshot-v1-16b-a3b", "train_4k", None,
                          {"moe_impl": "auto"}),
    "llama3_decode_flash": ("llama3-8b", "decode_32k", None,
                            {"flash_decode": True}),
}


def _chip_smoke():
    """``chip_smoke.py``, whose ``_RowsRead`` counts the batch rows a data
    parallel step reads on the card too (phase 19(b))."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shape_of(name: str):
    from repro_torch.configs.base import SHAPES
    return dataclasses.replace(SHAPES[name], seq_len=T, global_batch=B)


def cim_of(fields):
    from repro_torch.core.cim_linear import CIMConfig
    return None if fields is None else CIMConfig(**fields)


def run_case(case, mesh):
    """One real step of ``case`` on this rank: (collective bytes by kind,
    collective ops, the bytes of the arguments the rank holds; a train
    step's batch counted as the rows its step reads)."""
    from repro_torch.core import colshard
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params, place_tree, session_mesh
    arch, shape, cim, ov = case
    cell = build_cell(arch, shape_of(shape), mesh, reduced=True,
                      cim=cim_of(cim), overrides=ov, accum=1)
    model = get_model(cell.cfg)
    params = init_params(model.specs(cell.cfg), 0, device=CPU,
                         placements=cell.in_shardings[0], mesh=mesh)
    g = torch.Generator().manual_seed(3)
    sh = cell.shape
    with session_mesh(mesh, cell.rules):
        if cell.kind == "train":
            from repro_torch.train.trainer import make_train_step
            init_state, _ = make_train_step(model, cell.cfg, cell.run)
            second = place_tree(init_state(params), cell.in_shardings[1],
                                mesh)
            batch = {"tokens": torch.randint(
                0, cell.cfg.vocab, (sh.global_batch, sh.seq_len + 1),
                generator=g, dtype=torch.int32)}
            held = 0                   # the rows the step reads, below
        else:
            second = model.init_cache(cell.cfg, sh.global_batch,
                                      sh.seq_len, device=CPU)
            batch = torch.randint(0, cell.cfg.vocab, (sh.global_batch, 1),
                                  generator=g, dtype=torch.int32)
            held = tree_bytes(batch)
        held += tree_bytes(params) + tree_bytes(second)
        colshard.reset_collective_counts()
        with _chip_smoke()._RowsRead() as rows:
            cell.step_fn(params, second, batch)
        held += rows.bytes
    return dict(collectives=dict(colshard.collective.bytes),
                ops=sum(colshard.collective.ops.values()), held=held)


def body(rank, world, mesh, out_dir):
    from repro_torch.launch import mesh as lm
    m2 = lm.make_mesh(*MESH, device=CPU, backend="gloo")
    return {name: run_case(case, m2) for name, case in CASES.items()}
