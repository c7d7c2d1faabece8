"""Every decode cache the port allocates carries the placements of the
serve cell (``launch.cells.build_cell(...).in_shardings[1]``, the
reference's ``cache_shardings``): for every arch of the registry at its
published widths, every serve shape and the meshes (2, 2) and (16, 16),
each leaf of ``model.init_cache(cfg, b, max_len, device="meta")`` made
under the cell's session mesh holds the cell's placements, its global
shape and the block they give a rank. The mesh is rank 0 of a dry mesh
(``launch.mesh.dry_mesh``: PyTorch's fake process group); the cache is
``meta``, so no byte is allocated or moved. No leaf is exempt: the rows
over the batch axes; the time of K/V, their int8 scales and MLA's latent
cache, and the heads of the SSD state, over ``"model"``.
"""
import pytest
import torch
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import colshard
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import block_shape
from repro_torch.launch.mesh import MeshShape, dry_mesh
from repro_torch.models.registry import get_model
from repro_torch.nn.module import is_placements, session_mesh

SERVE = [n for n, s in SHAPES.items() if s.kind != "train"]
MESHES = {"2x2": (2, 2), "16x16": (16, 16)}


def _leaves(tree, path=""):
    """(path, leaf) of a cache tree, or of its placements tree (each
    leaf's tuple of placements)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)) and not is_placements(tree):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("sname", SERVE)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_carries_the_serve_cells_placements(arch, sname, mesh):
    shape = MeshShape(MESHES[mesh], ("data", "model"))
    kv8 = {"kv_cache_dtype": "int8"} if arch == "llama3-8b" else None
    with dry_mesh(shape) as dm:
        cell = build_cell(arch, sname, dm, overrides=kv8)
        want = dict(_leaves(cell.in_shardings[1]))
        structs = dict(_leaves(cell.arg_structs[1]))
        with session_mesh(dm, cell.rules):
            cache = get_model(cell.cfg).init_cache(
                cell.cfg, cell.shape.global_batch, cell.shape.seq_len,
                device="meta")
        got = dict(_leaves(cache))
        assert set(got) == set(want) == set(structs)
        for path, leaf in got.items():
            placed = (tuple(leaf.placements) if colshard.is_col_sharded(leaf)
                      else (Replicate(),) * len(MESHES[mesh]))
            assert placed == tuple(want[path]), (path, placed, want[path])
            assert leaf.shape == structs[path].shape, path
            assert leaf.dtype == structs[path].dtype, path
            assert tuple(colshard.local(leaf).shape) == block_shape(
                tuple(leaf.shape), want[path], dm), path
            assert colshard.local(leaf).device == torch.device("meta"), path
