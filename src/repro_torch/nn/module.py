"""Minimal functional module system (counterpart of ``repro.nn.module``).

Models are pairs of plain functions: ``specs(cfg)`` gives a nested dict of
``ParamSpec`` (shape, dtype, init, logical axes) and ``apply(params,
inputs, cfg)`` runs the model on a dict of tensors with the same nesting.
Parameters are materialized only by ``init_params``.

The logical axes map onto mesh axes through a rules table
(``resolve_pspec``, ``logical_to_mesh``); ``param_shardings`` gives each
leaf's placements on a ``DeviceMesh`` and ``shard_params`` realizes the
two the port runs (expert banks over ``"model"``, packed columns). The
process's session mesh (``set_activation_rules``, ``session_mesh``,
``current_mesh``) is what the parallel paths read (``kernels.ops``,
``models.layers``): in the port a
``torch.distributed`` ``DeviceMesh`` of one process per rank. ``constrain``
stays the identity: activations are never sharded, every rank holds them
whole. torch cannot reproduce ``jax.random``
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


def init_params(specs, seed: int, *, device=None):
    """Materialize parameters on ``device`` (``cuda`` unless ``"cpu"``).
    Each leaf draws from its own ``torch.Generator`` on that device,
    seeded from (``seed``, a hash of its tree path), so adding or removing
    a parameter never reshuffles the others."""
    dev = resolve_device(device)

    def build(tree, path=()):
        if isinstance(tree, ParamSpec):
            g = torch.Generator(device=dev)
            g.manual_seed((int(seed) * (2 ** 31 - 1) + _path_hash(path))
                          % (2 ** 63 - 1))
            return tree.initializer()(g, tuple(tree.shape), tree.dtype, dev)
        return {k: build(v, path + (k,)) for k, v in tree.items()}
    return build(specs)


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


_PLACEMENT_LEFT = ("ROADMAP queue 1, item 12b.3: FSDP (the embed axis over "
                   "the batch axes) and tensor parallelism over raw weights "
                   "(heads, mlp, vocab) are not ported yet")


def shard_params(params, specs, mesh, rules: Dict[str, Any], *,
                 device=None):
    """A replicated param tree as this rank's tree on ``mesh``, leaves on
    ``device`` (where they are when None). Two placements are realized:
    the ``"experts"`` axis of a raw expert bank over ``"model"`` (a
    ``DTensor`` of this rank's experts carrying the global shape,
    ``core.colshard.shard_dim``), and a packed CIM node's columns
    (``DeployArtifact.shard``'s rule: every node whose columns divide).
    Every other leaf stays whole; a placement ``rules`` puts anywhere
    else raises (``launch.mesh.expert_parallel_rules`` places the experts
    alone)."""
    from torch.distributed.tensor import Shard

    from repro_torch.api.artifact import _shard_node
    from repro_torch.core import colshard
    dev = None if device is None else resolve_device(device)
    names = tuple(mesh.mesh_dim_names)
    n_model = colshard.mesh_shards(mesh, "model")

    def on(x):
        return x if dev is None or not isinstance(x, torch.Tensor) else x.to(
            dev)

    def walk(node, spec, path):
        if isinstance(node, dict):
            if n_model > 1 and any(k.endswith("_digits") for k in node):
                return _shard_node(node, mesh, "model", n_model, dev,
                                   lambda sub: walk(sub, None, path))
            return {k: walk(v, None if not isinstance(spec, dict)
                            else spec.get(k), f"{path}/{k}")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, None, f"{path}/{i}") for i, v in enumerate(node)]
        if not isinstance(spec, ParamSpec):
            return on(node)
        dims = {}
        for name, pl in zip(names, _placements(
                resolve_pspec(spec.pspec, rules), names)):
            if (not isinstance(pl, Shard)
                    or colshard.mesh_shards(mesh, name) <= 1):
                continue
            if name != "model" or spec.pspec[pl.dim] != "experts":
                raise NotImplementedError(
                    f"shard_params: {path or '<root>'} (logical axes "
                    f"{spec.pspec}) is placed on mesh dim {name!r} at its "
                    f"dim {pl.dim}: {_PLACEMENT_LEFT}")
            dims[pl.dim] = (name,)
        if not dims:
            return on(node)
        return colshard.shard_dim(node, mesh, dims, device=dev)
    return walk(params, specs, "")


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


def constrain(x, logical):
    """Sharding hint of the reference: the identity (activations are whole
    on every rank)."""
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
