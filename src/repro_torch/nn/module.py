"""Minimal functional module system (counterpart of ``repro.nn.module``).

Models are pairs of plain functions: ``specs(cfg)`` gives a nested dict of
``ParamSpec`` (shape, dtype, init, logical axes) and ``apply(params,
inputs, cfg)`` runs the model on a dict of tensors with the same nesting.
Parameters are materialized only by ``init_params``.

The logical axes map onto mesh axes through a rules table
(``resolve_pspec``, ``logical_to_mesh``); ``param_shardings`` gives each
leaf's placements on a ``DeviceMesh`` and ``shard_params`` realizes
them (expert banks and raw weights over ``"model"``, FSDP's embed axis
over the batch axes, packed columns). The
process's session mesh (``set_activation_rules``, ``session_mesh``,
``current_mesh``) is what the parallel paths read (``kernels.ops``,
``models.layers``, ``nn.linear``): in the port a
``torch.distributed`` ``DeviceMesh`` of one process per rank.
``data_parallel`` marks a train step whose ranks hold their rows of the
batch. ``constrain`` stays the identity. torch cannot reproduce ``jax.random``
draws, so the port's ``init_params`` agrees with the reference only in
distribution; parity tests carry JAX-initialized params across as numpy
(``repro_torch.interop``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device

#: (generator, shape, dtype, device) -> tensor
InitFn = Callable[[torch.Generator, Tuple[int, ...], Any, torch.device],
                  torch.Tensor]


def torch_dtype(dtype) -> torch.dtype:
    """The storage dtype of a spec dtype: the ``"int4"`` marker (dense int4
    planes) is held as int8, as everywhere in the port."""
    return torch.int8 if dtype == "int4" else dtype


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    init: Union[str, InitFn] = "normal:0.02"
    pspec: Optional[Tuple[Optional[str], ...]] = None  # logical axes

    def initializer(self) -> InitFn:
        if callable(self.init):
            return self.init
        kind, _, arg = self.init.partition(":")
        if kind == "zeros":
            return lambda g, s, d, dev: torch.zeros(s, dtype=torch_dtype(d),
                                                    device=dev)
        if kind == "ones":
            return lambda g, s, d, dev: torch.ones(s, dtype=torch_dtype(d),
                                                   device=dev)
        if kind == "const":
            v = float(arg)
            return lambda g, s, d, dev: torch.full(s, v, dtype=torch_dtype(d),
                                                   device=dev)
        if kind == "normal":
            std = float(arg) if arg else 0.02
            return lambda g, s, d, dev: (_randn(g, s, dev) * std).to(
                torch_dtype(d))
        if kind == "fan_in":
            scale = float(arg) if arg else 1.0

            def fan_in(g, s, d, dev):
                fan = s[-2] if len(s) >= 2 else s[-1]
                return (_randn(g, s, dev) * scale / math.sqrt(fan)).to(
                    torch_dtype(d))
            return fan_in
        raise ValueError(f"unknown init {self.init!r}")


def _randn(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=g, dtype=torch.float32,
                       device=device)


def _path_hash(path: Tuple[str, ...]) -> int:
    h = 0
    for part in path:
        for ch in str(part):
            h = (h * 131 + ord(ch)) % (2 ** 31 - 1)
        h = (h * 131 + 7) % (2 ** 31 - 1)
    return h


def init_params(specs, seed: int, *, device=None, placements=None,
                mesh=None):
    """Materialize parameters on ``device`` (``cuda`` unless ``"cpu"``).
    Each leaf draws from its own ``torch.Generator`` on that device,
    seeded from (``seed``, a hash of its tree path), so adding or removing
    a parameter never reshuffles the others. With ``placements`` (a tree
    matching ``specs``, as ``launch.cells.build_cell`` gives them) on
    ``mesh``, each leaf is drawn whole and placed (``place``) before the
    next is drawn: the same values as the single device's, and a rank
    holds one whole leaf at a time."""
    dev = resolve_device(device)

    def build(tree, pl, path=()):
        if isinstance(tree, ParamSpec):
            g = torch.Generator(device=dev)
            g.manual_seed((int(seed) * (2 ** 31 - 1) + _path_hash(path))
                          % (2 ** 63 - 1))
            leaf = tree.initializer()(g, tuple(tree.shape), tree.dtype, dev)
            return leaf if placements is None else place(leaf, pl, mesh)
        return {k: build(v, None if pl is None else pl.get(k), path + (k,))
                for k, v in tree.items()}
    return build(specs, placements)


def resolve_pspec(logical: Optional[Tuple[Optional[str], ...]],
                  rules: Dict[str, Any]) -> Tuple:
    """Map logical axis names to mesh axes (the reference's
    ``PartitionSpec`` as a tuple), dropping duplicates (a mesh axis may
    appear at most once) and trailing ``None``s."""
    if logical is None:
        return ()
    used = set()
    out = []
    for ax in logical:
        target = rules.get(ax) if ax is not None else None
        if target is None:
            out.append(None)
            continue
        taxes = tuple(target) if isinstance(target, (tuple, list)) else (target,)
        taxes = tuple(t for t in taxes if t not in used)
        used.update(taxes)
        out.append(taxes if len(taxes) > 1 else (taxes[0] if taxes else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def logical_to_mesh(specs, rules: Dict[str, Any]):
    """Tree of resolved mesh-axis tuples from the logical annotations."""
    def build(tree):
        if isinstance(tree, ParamSpec):
            return resolve_pspec(tree.pspec, rules)
        return {k: build(v) for k, v in tree.items()}
    return build(specs)


def _placements(pspec: Tuple, names: Tuple[str, ...]) -> Tuple:
    from torch.distributed.tensor import Replicate, Shard

    def dim_of(name):
        return next((i for i, e in enumerate(pspec)
                     if e == name or (isinstance(e, tuple) and name in e)),
                    None)
    return tuple(Replicate() if dim_of(n) is None else Shard(dim_of(n))
                 for n in names)


def param_shardings(specs, mesh, rules: Dict[str, Any]):
    """Tree of each leaf's placements on ``mesh`` (a ``DeviceMesh``, or
    anything with ``mesh_dim_names``): one ``Shard(dim)`` or
    ``Replicate()`` per mesh dim, resolved from the leaf's logical axes
    through ``rules`` (``launch.mesh.sharding_rules``) as the reference's
    ``NamedSharding(mesh, resolve_pspec(...))`` places it."""
    names = tuple(mesh.mesh_dim_names)

    def build(tree):
        if isinstance(tree, ParamSpec):
            return _placements(resolve_pspec(tree.pspec, rules), names)
        return {k: build(v) for k, v in tree.items()}
    return build(specs)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dim name: ranks} of a ``DeviceMesh`` or of a shape record with
    ``mesh_dim_names`` and ``shape`` (``launch.mesh.MeshShape``)."""
    return dict(zip(tuple(mesh.mesh_dim_names),
                    (int(n) for n in tuple(mesh.shape))))


def is_placements(x) -> bool:
    """Whether ``x`` is one leaf's placements (a tuple of ``Shard`` /
    ``Replicate``), not a subtree."""
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def truncate_placements(placements: Tuple, shape, mesh) -> Tuple:
    """The reference's ``_truncate_sharding`` on placements: a tensor dim
    keeps the mesh dims splitting it only where their ranks' product
    divides it (and it is at least that large), and a split past the
    leaf's rank is dropped: odd vocabularies, 4d/3 FFNs and reduced
    optimizer states stay whole there."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    per_dim: Dict[int, int] = {}
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            per_dim[p.dim] = per_dim.get(p.dim, 1) * sizes[name]
    keep = {d for d, n in per_dim.items()
            if d < len(shape) and shape[d] % n == 0 and shape[d] >= n}
    return tuple(p if not isinstance(p, Shard) or p.dim in keep
                 else Replicate() for p in placements)


def block_dims(placements: Optional[Tuple], shape, mesh) -> Dict:
    """{tensor dim: mesh dims of more than one rank splitting it} of a leaf
    of ``shape`` under ``placements`` (truncated first; None: whole)."""
    from torch.distributed.tensor import Shard
    if placements is None:
        return {}
    sizes = mesh_sizes(mesh)
    dims: Dict[int, Tuple[str, ...]] = {}
    for name, p in zip(tuple(mesh.mesh_dim_names),
                       truncate_placements(placements, tuple(shape), mesh)):
        if isinstance(p, Shard) and sizes[name] > 1:
            dims[p.dim] = dims.get(p.dim, ()) + (name,)
    return dims


def place(x, placements: Optional[Tuple], mesh, *, device=None):
    """A whole leaf as this rank's block under ``placements`` on ``mesh``
    (truncated first): a ``DTensor`` of the block carrying the global
    shape where a mesh dim of more than one rank splits it, else the
    tensor itself (on ``device`` when given). None places it whole."""
    from repro_torch.core import colshard
    dev = None if device is None else resolve_device(device)
    if not isinstance(x, torch.Tensor):
        return x
    dims = block_dims(placements, tuple(x.shape), mesh)
    if colshard.is_col_sharded(x):
        if colshard.sharded_dims(x) == dims:      # placed so already
            return x if dev is None else colshard.like(x, colshard.local(
                x).to(dev))
        x = colshard.full_leaf(x)
    if not dims:
        return x if dev is None else x.to(dev)
    return colshard.shard_dim(x, mesh, dims, device=dev)


def place_tree(tree, placements, mesh, *, device=None):
    """``place`` over a tree and a matching tree of placements (a None
    subtree places its leaves whole)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, None if placements is None
                              else placements.get(k), mesh, device=device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place_tree(v, None if placements is None else placements[i],
                           mesh, device=device) for i, v in enumerate(tree)]
    if placements is not None and not is_placements(placements):
        raise ValueError(f"placements {placements!r} do not match a leaf of "
                         f"shape {tuple(getattr(tree, 'shape', ()))}")
    return place(tree, placements, mesh, device=device)


def shard_params(params, specs, mesh, rules: Dict[str, Any], *,
                 device=None):
    """A whole param tree as this rank's tree on ``mesh``, leaves on
    ``device`` (where they are when None): every placement that
    ``param_shardings`` resolves through ``rules``, truncated as the
    reference's ``build_cell`` truncates it (``truncate_placements``), is
    realized. A raw leaf becomes a ``DTensor`` of this rank's block
    carrying the global shape (``core.colshard.shard_dim``): expert banks
    over ``"model"``, tensor parallelism (heads, mlp, vocab over
    ``"model"``) and FSDP (embed over the batch axes); a 2-D placement
    such as ``wq``'s (embed over ``"data"``, heads over ``"model"``) is one
    ``DTensor`` over both dims. A packed CIM node keeps
    ``DeployArtifact.shard``'s rule (every node whose columns divide, over
    ``"model"``); rules that place a packed leaf on another mesh dim
    raise, naming it."""
    from repro_torch.api.artifact import _shard_node
    from repro_torch.core import colshard
    dev = None if device is None else resolve_device(device)
    n_model = colshard.mesh_shards(mesh, "model")
    shardings = param_shardings(specs, mesh, rules)

    def on(x):
        return x if dev is None or not isinstance(x, torch.Tensor) else x.to(
            dev)

    def packed_ok(node, pl, path):
        for k, v in node.items():
            p = pl.get(k) if isinstance(pl, dict) else None
            if not is_placements(p) or not isinstance(v, torch.Tensor):
                continue
            off = sorted({a for axes in block_dims(p, tuple(v.shape),
                                                   mesh).values()
                          for a in axes} - {"model"})
            if off:
                raise ValueError(
                    f"shard_params: {path}/{k} is a packed CIM leaf, placed "
                    f"by its columns over 'model' alone; the rules put it "
                    f"on {off}")

    def walk(node, spec, pl, path):
        if isinstance(node, dict):
            if any(k.endswith("_digits") for k in node):
                packed_ok(node, pl, path)
                if n_model > 1:
                    return _shard_node(node, mesh, "model", n_model, dev,
                                       lambda sub: walk(sub, None, None,
                                                        path))
            return {k: walk(v, spec.get(k) if isinstance(spec, dict)
                            else None, pl.get(k) if isinstance(pl, dict)
                            else None, f"{path}/{k}")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, None, None, f"{path}/{i}")
                    for i, v in enumerate(node)]
        if not isinstance(spec, ParamSpec) or not isinstance(
                node, torch.Tensor):
            return on(node)
        if tuple(node.shape) != tuple(spec.shape):
            raise ValueError(f"shard_params: {path} has shape "
                             f"{tuple(node.shape)}, its spec {spec.shape}")
        return place(node, pl, mesh, device=dev)
    return walk(params, specs, shardings, "")


def eval_shape_params(specs):
    """Shape and dtype records of every parameter (``meta`` tensors):
    nothing is allocated."""
    def build(tree):
        if isinstance(tree, ParamSpec):
            return torch.empty(tuple(tree.shape), dtype=torch_dtype(
                tree.dtype), device="meta")
        return {k: build(v) for k, v in tree.items()}
    return build(specs)


# ---------------------------------------------------------------------------
# the session mesh: the launcher installs it; the column-parallel CIM
# dispatch reads it, and a model runs unchanged without one
# ---------------------------------------------------------------------------
_ACTIVATION_RULES: Dict[str, Any] = {}
_CURRENT_MESH = None


def set_activation_rules(rules: Optional[Dict[str, Any]], mesh=None) -> None:
    """Install ``rules`` and ``mesh`` (a ``DeviceMesh`` or None) for the
    process's lifetime (what a serving rank does)."""
    global _ACTIVATION_RULES, _CURRENT_MESH
    _ACTIVATION_RULES = dict(rules) if rules else {}
    _CURRENT_MESH = mesh


def current_mesh():
    return _CURRENT_MESH


def current_rules() -> Dict[str, Any]:
    return dict(_ACTIVATION_RULES)


@contextlib.contextmanager
def session_mesh(mesh, rules: Optional[Dict[str, Any]] = None):
    """Install ``mesh`` (and ``rules``, else the current ones) on entry and
    restore the previous mesh and rules on exit."""
    prev_rules, prev_mesh = dict(_ACTIVATION_RULES), _CURRENT_MESH
    set_activation_rules(rules if rules is not None else prev_rules, mesh)
    try:
        yield mesh
    finally:
        set_activation_rules(prev_rules, prev_mesh)


_DATA_PARALLEL: Optional[Tuple[Any, Tuple[str, ...]]] = None


@contextlib.contextmanager
def data_parallel(mesh, axes: Tuple[str, ...]):
    """Inside, each rank holds its rows of the batch over the mesh dims
    ``axes`` (a data parallel train step, ``train.trainer``): the loss is
    the global mean (summed over ``axes``), LSQ's g counts the global
    batch, and the expert-parallel MoE takes its input as these rows."""
    global _DATA_PARALLEL
    prev, _DATA_PARALLEL = _DATA_PARALLEL, (mesh, tuple(axes))
    try:
        yield
    finally:
        _DATA_PARALLEL = prev


def batch_parallel() -> Optional[Tuple[Any, Tuple[str, ...]]]:
    """(mesh, batch axes) while a data parallel step runs, else None."""
    return _DATA_PARALLEL


def batch_ranks() -> int:
    """The ranks a data parallel step splits the batch over (1 outside
    one)."""
    if _DATA_PARALLEL is None:
        return 1
    sizes = mesh_sizes(_DATA_PARALLEL[0])
    return math.prod(sizes[a] for a in _DATA_PARALLEL[1])


def constrain(x, logical):
    """Sharding hint of the reference: the identity (outside a data
    parallel step activations are whole on every rank; inside one each
    rank holds its batch rows, and the placements of the weights decide
    every collective)."""
    return x


def stack_specs(specs, n: int):
    """Prepend a layer axis of ``n`` (the reference's scan-over-layers
    stacking). Each layer's slice is drawn with the unstacked shape, one
    after the other from the leaf's generator."""
    def build(tree):
        if isinstance(tree, ParamSpec):
            ps = (None,) + tree.pspec if tree.pspec is not None else None
            base = tree.initializer()

            def stacked(g, s, d, dev, _base=base):
                out = torch.empty(s, dtype=torch_dtype(d), device=dev)
                for i in range(s[0]):
                    out[i] = _base(g, s[1:], d, dev)
                return out

            return ParamSpec(shape=(n,) + tuple(tree.shape), dtype=tree.dtype,
                             init=stacked, pspec=ps)
        return {k: build(v) for k, v in tree.items()}
    return build(specs)
