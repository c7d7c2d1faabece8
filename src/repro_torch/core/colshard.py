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

The expert-parallel MoE and the sequence-parallel flash decode place
leaves on another axis (``shard_dim``: an expert bank's experts, a decode
cache's time and batch rows), read through ``local``/``like``/``select``
the same way, and use the collectives below, each over the process groups
of named mesh dims: ``all_reduce`` (sum or max, float32), ``all_gather``
(along a dim), and two autograd operators: ``psum`` (forward a sum over
the dims, backward the identity: the reference's ``psum`` at the end of a
``shard_map`` body) and ``grad_psum`` (forward the identity, backward a
sum over the dims: where a replicated input enters a rank-local part of a
computation whose loss every rank computes whole). ``collective.calls``
and ``collective.seconds`` count their calls and host seconds. gloo takes
CUDA tensors for every one of them; nothing switches backend.

``collective.bytes`` and ``collective.ops`` count every collective of
this module by kind (``KINDS``), ``gather_cols`` and ``gather_first``
included: the bytes of each op's output, as the reference's dry run reads
them from the compiled HLO (an all-gather's gathered tensor, an
all-reduce's tensor, a gather's gathered tensor on its root and nothing
elsewhere). They count the same on a gloo or NCCL group as on the dry
run's fake one (``launch.mesh.dry_mesh``), where no byte moves. The port
issues no reduce-scatter or broadcast (gloo has neither for CUDA
tensors: FSDP's backward is an all-reduce and a slice), so those kinds
stay 0. ``collective.axes`` counts each kind's ops by the mesh dim they
run over (a data parallel serve step's test: no all-gather over
``"data"``). ``reset_collective_counts`` zeroes them.

FSDP and raw-weight tensor parallelism read placed weights at use:
``unshard_batch`` gathers the dims the batch axes split
(``fsdp_gather``: an all-gather forward, a reduce-scatter backward: each
rank's cotangent holds its batch rows' part), ``whole`` then gathers the
``"model"`` split too (``gather``: its backward takes the rank's block of
the replicated cotangent), and a layer that reads its leaves directly
takes ``at_use``. Megatron's pair is ``grad_psum`` (the input of a
column-parallel layer; ``col_matmul`` for a plain product, its sum in
float32) and ``psum`` (the output of a row-parallel one, whose input
enters through ``split``). None scales by the rank count.
``gather_first`` brings a placed leaf whole to the first rank's host (a
checkpoint's write).
"""
from __future__ import annotations

import dataclasses
import math
import time
import types
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


def wrap(local: torch.Tensor, cols: ColRange) -> DTensor:
    """A local column shard as the sharded leaf of ``cols.n`` columns."""
    return placed(local, cols.mesh,
                  placements_of(cols.mesh, {local.ndim - 1: (cols.axis,)}),
                  tuple(local.shape[:-1]) + (cols.n,))


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
    _count("all-gather", _nbytes(local) * cols.shards, cols.axis)
    gather_cols.calls += 1
    gather_cols.seconds += time.perf_counter() - t0
    return out


gather_cols.calls = 0
gather_cols.seconds = 0.0


def full_leaf(x):
    """A sharded or placed leaf gathered to its full plain tensor on every
    rank (a collective); any other leaf as it is."""
    if not isinstance(x, DTensor):
        return x
    dims = sharded_dims(x)
    if set(dims) == {x.ndim - 1} and len(dims[x.ndim - 1]) == 1:
        return gather_cols(x.to_local(), range_of(x))
    out = x.to_local()
    for dim, axes in dims.items():
        out = all_gather(out, x.device_mesh, axes, dim)
    return out


def gather_first(x):
    """A placed leaf whole, on the CPU of the rank at coordinate 0 of every
    mesh dim splitting it (None on every other rank); any other leaf as it
    is. Each dim's blocks go to the first rank of that dim's group as host
    tensors (``dist.gather``), row-major as ``shard_dim`` cut them: a
    quarter of an all-gather's traffic on four ranks, and no other rank
    holds the whole leaf. Every rank of the mesh calls it."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    out, done = x.to_local().detach().cpu(), set()
    for dim, axes in sharded_dims(x).items():
        for a in reversed(axes):
            if mesh_shards(mesh, a) <= 1:
                continue
            if any(coord[b] for b in done):     # not a first rank: done
                return None
            g = mesh.get_group(a)
            first = dist.get_global_rank(g, 0)
            parts = ([torch.empty_like(out) for _ in range(
                mesh_shards(mesh, a))] if coord[a] == 0 else None)
            t0 = time.perf_counter()
            dist.gather(out.contiguous(), parts, dst=first, group=g)
            _count("gather", _nbytes(out) * len(parts) if parts else 0, a)
            collective.calls += 1
            collective.seconds += time.perf_counter() - t0
            done.add(a)
            if coord[a]:
                return None
            out = torch.cat(parts, dim=dim)
    return out if not any(coord[b] for b in done) else None


def full_tree(tree):
    """Every sharded leaf of a nested dict/list tree gathered (every rank
    must call it)."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [full_tree(v) for v in tree]
    return full_leaf(tree)


# ---------------------------------------------------------------------------
# leaves placed on another axis: expert banks, decode caches
# ---------------------------------------------------------------------------

def mesh_coord(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without it)."""
    if mesh_shards(mesh, axis) <= 1:
        return 0
    return int(mesh.get_local_rank(mesh_dim=axis))


def batch_shard(mesh, axes) -> tuple:
    """(shards, index) of this rank over the batch ``axes`` of ``mesh``,
    row-major, as the reference's ``P(("pod", "data"))`` splits rows."""
    n, i = 1, 0
    for a in axes:
        d = mesh_shards(mesh, a)
        n, i = n * d, i * d + mesh_coord(mesh, a)
    return n, i


def placed(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """``local`` as the placed leaf of global ``shape`` (no copy, no
    collective; differentiable with respect to ``local``). Its strides
    are the contiguous ones of ``shape``, computed without a tensor (an
    empty ``meta`` tensor of the global shape would count as a live
    storage of that size in the dry run)."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def shard_dim(x: torch.Tensor, mesh, dims: dict, device=None) -> DTensor:
    """A full (replicated) tensor as the placed leaf holding this rank's
    block: ``dims`` maps tensor dims to the mesh axes splitting them, in
    row-major order (e.g. ``{0: ("model",)}`` for an expert bank, ``{1:
    ("data",), 2: ("model",)}`` for a decode cache). Each split dim must
    divide. Only the block is copied (to ``device``, else ``x``'s)."""
    local = x
    for dim, axes in dims.items():
        n, i = batch_shard(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {n} ranks of {axes}")
        w = x.shape[dim] // n
        local = local.narrow(dim, i * w, w)
    local = local.contiguous() if device is None else local.to(
        device).contiguous()
    return placed(local, mesh, placements_of(mesh, dims), x.shape)


def placements_of(mesh, dims: dict) -> list:
    """The placements of ``shard_dim``'s ``dims`` over ``mesh``'s dims."""
    out = []
    for name in mesh.mesh_dim_names:
        hit = [d for d, axes in dims.items() if name in axes]
        out.append(Shard(hit[0]) if hit else Replicate())
    return out


def local(x):
    """A placed leaf's local tensor; any other value as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def like(ref, value: torch.Tensor):
    """``value`` (a local tensor) placed as ``ref`` is, when ``ref`` is a
    placed leaf; else ``value`` itself."""
    if not isinstance(ref, DTensor):
        return value
    return placed(local(value), ref.device_mesh, ref.placements, ref.shape)


def sharded_dims(x: DTensor) -> dict:
    """{tensor dim: mesh axes splitting it} of a placed leaf."""
    names = x.device_mesh.mesh_dim_names
    out: dict = {}
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            out[p.dim % x.ndim] = out.get(p.dim % x.ndim, ()) + (name,)
    return out


def select(x, i: int):
    """``x[i]`` along a leading axis no mesh dim splits: a placed leaf's
    layer ``i`` stays placed (its split dims shift down by one)."""
    if not isinstance(x, DTensor):
        return x[i]
    return _drop_leading(x, x.to_local()[i])


def unbind(x) -> list:
    """``torch.unbind(x)`` along the leading axis, placed leaves kept
    placed (one unbind of the local tensor: its backward stacks once)."""
    if not isinstance(x, DTensor):
        return list(torch.unbind(x))
    return [_drop_leading(x, v) for v in torch.unbind(x.to_local())]


def _drop_leading(x: DTensor, value: torch.Tensor) -> DTensor:
    places = []
    for p in x.placements:
        if isinstance(p, Shard):
            if p.dim % x.ndim == 0:
                raise ValueError("the leading axis of a placed leaf is split "
                                 "over the mesh: it cannot be indexed")
            p = Shard(p.dim % x.ndim - 1)
        places.append(p)
    return placed(value, x.device_mesh, places, x.shape[1:])


def rows_view(x, axes):
    """A cache leaf placed with its rows over the batch ``axes``, as a data
    parallel step reads it: the rank's block with that split dropped (the
    rows are the rank's own) and its other splits kept (a K/V or latent
    cache's time, the SSD state's heads, over ``"model"``): a placed leaf
    of the rank's rows, or the local tensor where nothing else splits it.
    Raises on a leaf whose rows are not placed over ``axes``."""
    want = tuple(a for a in axes if mesh_shards(x.device_mesh, a) > 1) \
        if isinstance(x, DTensor) else tuple(axes)
    dims = {d: tuple(a for a in ax if mesh_shards(x.device_mesh, a) > 1)
            for d, ax in sharded_dims(x).items()} \
        if isinstance(x, DTensor) else {}
    rows = [d for d, ax in dims.items() if ax == want]
    if not rows:
        raise ValueError(f"a {tuple(x.shape)} cache leaf does not hold its "
                         f"rows over {tuple(axes)}: make the cache with "
                         "init_cache under the session mesh")
    keep = {d: ax for d, ax in dims.items() if d != rows[0] and ax}
    loc = x.to_local()
    if not keep:
        return loc
    shape = list(x.shape)
    shape[rows[0]] = loc.shape[rows[0]]
    return placed(loc, x.device_mesh, placements_of(x.device_mesh, keep),
                  shape)


def holds_rows(x, axes) -> bool:
    """Whether a leaf is placed with a dim split over any of the batch
    ``axes`` (of more than one rank)."""
    if not isinstance(x, DTensor):
        return False
    split = {a for ax in sharded_dims(x).values() for a in ax
             if mesh_shards(x.device_mesh, a) > 1}
    return bool(split & set(axes))


# ---------------------------------------------------------------------------
# collectives over named mesh dims
# ---------------------------------------------------------------------------

#: the kinds of collective that ``collective.bytes`` and ``.ops`` count
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "broadcast", "gather")

#: counters of ``all_reduce`` and ``all_gather``: ``calls`` and their host
#: ``seconds`` (the autograd operators' collectives included); ``bytes``
#: and ``ops`` by kind over every collective of this module, and ``axes``:
#: {kind: {mesh dim: ops}}
collective = types.SimpleNamespace(calls=0, seconds=0.0,
                                   bytes=dict.fromkeys(KINDS, 0),
                                   ops=dict.fromkeys(KINDS, 0),
                                   axes={k: {} for k in KINDS})


def reset_collective_counts() -> None:
    """Zero ``collective.bytes``, ``collective.ops`` and
    ``collective.axes``."""
    collective.bytes = dict.fromkeys(KINDS, 0)
    collective.ops = dict.fromkeys(KINDS, 0)
    collective.axes = {k: {} for k in KINDS}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _count(kind: str, nbytes: int, axis: str) -> None:
    collective.bytes[kind] += int(nbytes)
    collective.ops[kind] += 1
    collective.axes[kind][axis] = collective.axes[kind].get(axis, 0) + 1


def _timed(kind: str, nbytes: int, axis: str, fn, *args, **kw) -> None:
    t0 = time.perf_counter()
    fn(*args, **kw)
    _count(kind, nbytes, axis)
    collective.calls += 1
    collective.seconds += time.perf_counter() - t0


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` summed (``op="sum"``) or maxed over the ranks of
    ``mesh``'s dims ``axes``."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    out = x.contiguous().clone()
    for a in axes:
        if mesh_shards(mesh, a) > 1:
            _timed("all-reduce", _nbytes(out), a, dist.all_reduce, out,
                   op=red, group=mesh.get_group(a))
    return out


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` over ``axes`` concatenated along ``dim``, row-major
    as ``batch_shard`` numbers them."""
    out = x.contiguous()
    for a in reversed(tuple(axes)):
        if mesh_shards(mesh, a) <= 1:
            continue
        parts = [torch.empty_like(out) for _ in range(mesh_shards(mesh, a))]
        _timed("all-gather", _nbytes(out) * len(parts), a, dist.all_gather,
               parts, out, group=mesh.get_group(a))
        out = torch.cat(parts, dim=dim)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """Forward: the ranks' blocks over ``axes`` gathered along ``dim``;
    backward: this rank's block of the cotangent. The computation after
    the gather is replicated over ``axes``, so every rank holds the whole
    cotangent already: no sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.n, ctx.dim = x.shape[dim], dim
        ctx.i = batch_shard(mesh, axes)[1]
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None, None, None


class _FsdpGather(torch.autograd.Function):
    """Forward: the ranks' blocks over ``axes`` gathered along ``dim`` (FSDP's
    weight gather); backward: the cotangents summed over ``axes`` and this
    rank's block taken (a reduce-scatter: each rank's cotangent holds only
    its batch rows' part). The sum is an all-reduce and a slice: gloo has no
    reduce-scatter."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.n, ctx.dim = mesh, axes, x.shape[dim], dim
        ctx.i = batch_shard(mesh, axes)[1]
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g, ctx.mesh, ctx.axes)
        return g.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None, None, None


class _Split(torch.autograd.Function):
    """Forward: this rank's block of ``x`` along ``dim`` over ``axes``;
    backward: the ranks' cotangent blocks gathered (each rank's part of
    the computation after the split sees only its block)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        n, i = batch_shard(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {n} ranks of {axes}")
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        w = x.shape[dim] // n
        return x.narrow(dim, i * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ColMatmul(torch.autograd.Function):
    """Forward: ``x @ w`` for this rank's columns ``w``, in the operands'
    dtype (per element the single device's product); backward: ``w``'s
    gradient the same way, and ``x``'s the ranks' partial products summed
    over ``axes`` in float32, then rounded once to ``x``'s dtype (a bf16
    partial rounded on each rank before the sum would be one more
    rounding than the single device's GEMM)."""

    @staticmethod
    def forward(ctx, x, w, mesh, axes):
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.axes = mesh, axes
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = all_reduce(g.to(torch.float32) @ w.to(torch.float32).t(),
                        ctx.mesh, ctx.axes).to(x.dtype)
        dw = (x.reshape(-1, x.shape[-1]).t()
              @ g.reshape(-1, g.shape[-1]).to(x.dtype))
        return dx, dw.to(w.dtype), None, None


def col_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x @ w`` on this rank's columns ``w`` of a column-parallel layer
    whose input ``x`` every rank holds whole: the input's gradient sums
    the ranks' parts over ``axes`` (Megatron's f and the product in one,
    the sum in float32)."""
    return _ColMatmul.apply(x, w, mesh, tuple(axes))


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Forward: ``x`` summed over ``axes``; backward: the identity (every
    rank holds the whole cotangent of the sum)."""
    return _Psum.apply(x, mesh, tuple(axes))


def grad_psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Forward: the identity; backward: the cotangent summed over ``axes``
    (each rank's part of it comes from its rank-local computation)."""
    return _GradPsum.apply(x, mesh, tuple(axes))


def gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Forward: the ranks' blocks over ``axes`` concatenated along ``dim``;
    backward: this rank's block of the (replicated) cotangent. A
    column-parallel output, and the expert-parallel MoE's batch blocks,
    leave through it."""
    return _Gather.apply(x, mesh, tuple(axes), dim % x.ndim)


def split(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Forward: this rank's block of ``x`` along ``dim`` over ``axes``;
    backward: the blocks' cotangents gathered. A row-parallel input enters
    through it."""
    return _Split.apply(x, mesh, tuple(axes), dim % x.ndim)


def fsdp_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """FSDP's weight gather: forward the ranks' blocks over the batch
    ``axes`` concatenated along ``dim``, backward the cotangent summed over
    them and this rank's block taken."""
    return _FsdpGather.apply(x, mesh, tuple(axes), dim % x.ndim)


# ---------------------------------------------------------------------------
# placed raw weights at use: FSDP and tensor parallelism
# ---------------------------------------------------------------------------

def unshard_batch(x):
    """A placed leaf with every dim that a mesh dim other than ``"model"``
    splits (FSDP's embed axis over the batch axes) gathered through
    ``fsdp_gather``: a leaf placed over ``"model"`` alone stays placed (its
    local block now whole on the batch axes), any other comes back as its
    plain tensor. Called where a layer takes its weights, so a rank holds
    one layer's gathered weights at a time."""
    if not isinstance(x, DTensor):
        return x
    mesh, loc, keep = x.device_mesh, x.to_local(), {}
    for dim, axes in sharded_dims(x).items():
        batch = tuple(a for a in axes if a != "model")
        if batch:
            loc = fsdp_gather(loc, mesh, batch, dim)
        if "model" in axes:
            if batch:
                raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf is "
                                 f"split over {axes} together: FSDP and "
                                 "tensor parallelism split different dims")
            keep[dim] = ("model",)
    if not keep:
        return loc
    return placed(loc, mesh, placements_of(mesh, keep), x.shape)


def unshard_tree(tree):
    """``unshard_batch`` over every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unshard_tree(v) for v in tree)
    return unshard_batch(tree)


def at_use(tree):
    """A layer's params as a block that reads its leaves directly takes
    them: every leaf whole (``whole``: FSDP's and ``"model"``'s splits
    gathered, the computation after replicated), but the linear nodes
    (dicts holding ``"w"`` or packed ``"w_digits"``), which
    ``nn.linear.apply_linear`` runs on their placed blocks (a packed
    node's column shards through the column-parallel dispatch)."""
    if isinstance(tree, dict):
        if "w" in tree or "w_digits" in tree:
            return tree
        return {k: at_use(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(at_use(v) for v in tree)
    return whole(tree)


def model_dim(x):
    """The dim of a placed leaf that ``"model"`` splits (None when it splits
    none, or for a plain tensor)."""
    if not isinstance(x, DTensor):
        return None
    return next((d for d, axes in sharded_dims(x).items()
                 if "model" in axes), None)


def whole(x):
    """A leaf placed over ``"model"`` gathered whole on every rank (the
    computation after it is replicated: the backward takes this rank's
    block); a plain tensor as it is. Batch-axis splits go first
    (``unshard_batch``)."""
    x = unshard_batch(x)
    if not isinstance(x, DTensor):
        return x
    out = x.to_local()
    for dim, axes in sharded_dims(x).items():
        out = gather(out, x.device_mesh, axes, dim)
    return out
