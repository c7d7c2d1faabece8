"""Column-sharded leaves of a packed tree (column-parallel serving,
DESIGN.md §10; the counterpart of the reference's ``NamedSharding`` over
the ``"model"`` mesh axis).

The port is SPMD: one process per rank. A CIM node whose columns divide
the rank count holds each digit plane, occupancy map and column-length
scale as a ``DTensor`` sharded on its last axis (``Shard(-1)``): the
rank's columns are its local tensor, and the DTensor records the global
shape and the mesh. Every other leaf is a plain tensor, the same on every
rank (replicated). The port computes on the local tensors only:
``col_apply`` runs a column-preserving function on the rank's columns of
its operands and wraps the result back, and ``localize`` gives the rank's
columns of any operand -- a sharded leaf's local tensor, or the slice of a
full (replicated) one after padding its columns to a multiple of the rank
count, as ``kernels.ops.pad_cols`` pads them. No DTensor operator runs:
no sharding propagation, no implicit collective.

``gather_cols`` is the one collective of the sharded dispatch: an
all-gather of each rank's (..., N/D) float32 outputs over the mesh axis's
process group (the list form, which gloo takes for CUDA tensors too),
concatenated and sliced back to N. ``gather_cols.calls`` and
``gather_cols.seconds`` count its calls and their host seconds.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class ColRange:
    """The columns rank ``rank`` holds of ``n`` split over ``shards``
    ranks of ``mesh``'s ``axis``: ``width`` = ceil(n / shards) padded
    columns from ``lo``; the real ones end at ``hi``."""

    mesh: object
    axis: str
    n: int
    shards: int
    rank: int

    @property
    def width(self) -> int:
        return math.ceil(self.n / self.shards)

    @property
    def lo(self) -> int:
        return self.rank * self.width

    @property
    def hi(self) -> int:
        return min(self.lo + self.width, self.n)

    @property
    def real(self) -> int:
        """Real (unpadded) columns of this rank: the first ``real`` of its
        ``width``."""
        return max(0, self.hi - self.lo)


def mesh_shards(mesh, axis: str) -> int:
    """Ranks along ``axis`` of a ``DeviceMesh`` (1 without it)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if mesh is None or axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))


def check_mesh(mesh, axis: str) -> None:
    """Raise unless ``mesh`` is a ``DeviceMesh`` with a dim ``axis``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_mesh), got {type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no dim {axis!r}: its dims are "
                         f"{mesh.mesh_dim_names}")


def col_range(mesh, axis: str, n: int) -> ColRange:
    return ColRange(mesh=mesh, axis=axis, n=int(n),
                    shards=mesh_shards(mesh, axis),
                    rank=int(mesh.get_local_rank(mesh_dim=axis)))


def is_col_sharded(x) -> bool:
    return isinstance(x, DTensor)


def range_of(x: DTensor) -> ColRange:
    """The column range a sharded leaf records."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    axis = next(names[i] for i, p in enumerate(x.placements)
                if isinstance(p, Shard))
    return col_range(mesh, axis, x.shape[-1])


def localize(x, cols: ColRange, pad_value: float = 0.0):
    """The rank's columns of ``x``: a sharded leaf's local tensor; for a
    full leaf (last axis ``cols.n``), its columns padded with
    ``pad_value`` to ``shards * width`` and sliced at the rank's range;
    anything else (None, a broadcast scale) as it is. A slice comes back
    contiguous, as the kernels take it."""
    if isinstance(x, DTensor):
        return x.to_local()
    if not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[-1] != cols.n:
        return x
    pad = cols.shards * cols.width - cols.n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=pad_value)
    return x[..., cols.lo:cols.lo + cols.width].contiguous()


def _placements(cols: ColRange, dim: int):
    return [Shard(dim) if name == cols.axis else Replicate()
            for name in cols.mesh.mesh_dim_names]


def wrap(local: torch.Tensor, cols: ColRange) -> DTensor:
    """A local column shard as the sharded leaf of ``cols.n`` columns."""
    shape = tuple(local.shape[:-1]) + (cols.n,)
    stride = tuple(int(s) for s in torch.empty(shape, device="meta").stride())
    return DTensor.from_local(local, cols.mesh, _placements(cols, local.ndim - 1),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def shard_leaf(x: torch.Tensor, mesh, axis: str, device=None) -> DTensor:
    """A full leaf as the sharded leaf holding this rank's columns on
    ``device`` (else ``x``'s): only those columns are copied there. The
    columns must divide the rank count."""
    cols = col_range(mesh, axis, x.shape[-1])
    if cols.n % cols.shards:
        raise ValueError(f"{cols.n} columns do not divide over "
                         f"{cols.shards} ranks")
    local = localize(x, cols).contiguous()
    return wrap(local if device is None else local.to(device), cols)


def col_apply(fn: Callable, *xs):
    """``fn(*xs)`` for a column-preserving ``fn``. With a sharded leaf
    among ``xs``, ``fn`` runs on every operand's rank columns
    (``localize``) and its result is wrapped as a sharded leaf; without
    one, it is ``fn(*xs)`` itself."""
    sharded = next((x for x in xs if isinstance(x, DTensor)), None)
    if sharded is None:
        return fn(*xs)
    cols = range_of(sharded)
    return wrap(fn(*(localize(x, cols) for x in xs)), cols)


def gather_cols(local: torch.Tensor, cols: ColRange) -> torch.Tensor:
    """All-gather the ranks' (..., width) outputs over the mesh axis into
    (..., n): the column-parallel dispatch's one collective."""
    t0 = time.perf_counter()
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(cols.shards)]
    dist.all_gather(parts, local, group=cols.mesh.get_group(cols.axis))
    out = torch.cat(parts, dim=-1)[..., :cols.n]
    gather_cols.calls += 1
    gather_cols.seconds += time.perf_counter() - t0
    return out


gather_cols.calls = 0
gather_cols.seconds = 0.0


def full_leaf(x):
    """A sharded leaf gathered to its full plain tensor on every rank (a
    collective); any other leaf as it is."""
    if not isinstance(x, DTensor):
        return x
    cols = range_of(x)
    return gather_cols(x.to_local(), cols)


def full_tree(tree):
    """Every sharded leaf of a nested dict/list tree gathered (every rank
    must call it)."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [full_tree(v) for v in tree]
    return full_leaf(tree)
