"""Whole-model packing and the in-memory deploy artifact (counterpart of
``repro.api.artifact``).

``pack_model`` packs every dict node carrying the CIM-layer quartet {w,
s_w, s_p, s_a}: linear for a 2-D ``w``, conv for a 4-D HWIO ``w``, and
their stacked (scan-over-layers) forms, rank 3 and rank 5, one layer at a
time. MoE expert banks -- flat ``nm``/``nm_s_w``/``nm_s_p``/``nm_s_a``
keys with leading (layer, expert) axes -- pack per expert into
``nm_digits`` planes with ``nm_occ``, ``nm_k_logical`` and per-expert
scales. Every other node (embeddings, norms, routers, full-precision
stems, BatchNorm) passes through. With a variation source and a sigma
(``variation``, ``variation_std``: the reference's ``variation_key``,
``variation_std``) one device realization is baked into float32 planes,
each node from its own source (``variation.for_layer(path)``), a stacked
node's layers and a bank's experts from ``split`` (the reference's
``jax.random.split`` of the node's key); those planes serve through the
float-digit kernels as drifted planes do.

``DeployArtifact`` is the unit a server loads: the packed tree, the
``CIMConfig`` pinned to a packed backend, the layout version and ``meta``
(``meta["col_shard"]`` from ``col_shard_axes``). ``save`` and ``load``
use the reference's on-disk layout, so an artifact packed by either
package serves on the other, bit for bit::

    <path>/
      artifact.json        format, layout_version, kind, backend, config,
                           meta (written last: its presence marks a
                           complete artifact)
      step_00000000/       repro_torch.checkpoint leaf store of ``params``

``load`` migrates layouts 1-3 in memory (``_migrate_pre_v4``).

Column-parallel serving (DESIGN.md §10): ``shard(mesh)`` and
``load(path, mesh=)`` place every CIM node whose columns divide the
mesh's ``"model"`` ranks column-sharded: its digit planes and every leaf
carrying its bank's column axis become ``core.colshard`` sharded leaves
holding this rank's columns; ragged nodes and every other leaf stay whole
on every rank (the kernel dispatch pads and splits ragged nodes per
call). ``save`` of a sharded artifact gathers its leaves (every rank
calls it) and the mesh's rank 0 writes the same files as the unsharded
save.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device, to_device, tree_leaves
from repro_torch.checkpoint import ckpt as _ckpt
from repro_torch.core import colshard
from repro_torch.core.cim_linear import CIMConfig

#: Artifact layout of the reference this port reads and writes: int4
#: planes nibble-packed, a ``w_occ`` occupancy map beside every standard
#: plane. Layout 2 added the optional per-node ``deq_scale`` leaf, layout
#: 3 the ``backend`` stamp in the header.
ARTIFACT_LAYOUT_VERSION = 4

#: Version of the ScaleDelta side-artifact format (in-service
#: recalibration), stamped into ``meta["delta_version"]`` of an artifact
#: it was applied to; ``load`` refuses a newer one.
SCALE_DELTA_VERSION = 1

#: What introduced each on-disk format version, named in version errors
#: so "which side is stale" is answerable from the message.
_LAYOUT_WRITERS = {1: "the lifecycle API", 2: "self-healing serving",
                   3: "hardware-style backends",
                   4: "nibble planes and occupancy maps"}
_DELTA_WRITERS = {1: "self-healing serving"}
_FORMAT = "repro.api.DeployArtifact"

_KINDS = ("linear", "conv", "model")


class ArtifactVersionError(ValueError):
    """A DeployArtifact carries a format version this build cannot honor.
    Carries ``field``/``found``/``supported`` so tooling can triage
    without parsing the message."""

    def __init__(self, what: str, field: str, found, supported: int, *,
                 writers: Optional[Dict[int, str]] = None,
                 relation: str = "<=", detail: str = ""):
        self.field, self.found, self.supported = field, found, supported
        writers = writers or {}
        by = writers.get(found) if isinstance(found, int) else None
        ours = writers.get(supported)
        msg = (f"{what} has {field} {found!r}"
               + (f" (written by {by})" if by else "")
               + f"; this build expects {field} {relation} {supported}"
               + (f" (writer: {ours})" if ours else "") + ".")
        if detail:
            msg += " " + detail
        super().__init__(msg)


def _dense_int4(cfg: CIMConfig) -> bool:
    """True when ``cfg``'s int8 digit planes stand for int4 ones: the
    standard pack's int4 grid (``store_dtype``), or any int4 pack of a
    backend with its own plane format (binary's sign planes)."""
    from .backends import has_own_pack
    return cfg.pack_dtype == "int4" and (has_own_pack(cfg)
                                         or cfg.cell_bits <= 3)


def _mark_int4(params, cfg: CIMConfig):
    """The params tree with every dense int4 digit plane wrapped in
    ``checkpoint.Int4``, so it is saved under the logical dtype ``int4``
    as the reference saves it."""
    if not _dense_int4(cfg):
        return params

    def walk(node):
        if isinstance(node, dict):
            return {k: (_ckpt.Int4(v) if (k.endswith("_digits")
                                          and isinstance(v, torch.Tensor)
                                          and v.dtype == torch.int8)
                        else walk(v)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node
    return walk(params)


def _migrate_pre_v4(params, cfg: CIMConfig):
    """In-memory migration of a layout 1-3 params tree to layout 4: every
    standard digit-plane leaf (``*_digits``) gains its ``*_occ`` sibling
    (computed from the planes as stored; multiplicative noise keeps dead
    cells dead, so variation-baked float planes are exact too), and dense
    int4 planes nibble-pack where the packed axis is even. Backends with
    their own plane format (binary) pass through."""
    from repro_torch.core.nibble import (INT4, can_pack_nibbles,
                                         occupancy_map, pack_nibbles)
    from .backends import has_own_pack
    if has_own_pack(cfg):
        return params
    int4 = _dense_int4(cfg)

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if isinstance(v, (dict, list, tuple)):
                    out[k] = walk(v)
                    continue
                out[k] = v
                if not k.endswith("_digits"):
                    continue
                # conv planes are the quartet key with the 6-D (or stacked
                # 7-D) shape; every other rank is linear
                conv = k == "w_digits" and v.ndim >= 6
                occ_key = k[: -len("_digits")] + "_occ"
                if occ_key not in node:
                    out[occ_key] = occupancy_map(v, conv=conv)
                if (int4 and v.dtype == torch.int8
                        and can_pack_nibbles(v.shape[-2], INT4)):
                    out[k] = pack_nibbles(v)
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return node
    return walk(params)
_CIM_LAYER_KEYS = frozenset({"w", "s_w", "s_p", "s_a"})
_BANK_SCALES = ("s_w", "s_p", "s_a")


def _is_cim_layer(node) -> bool:
    return (isinstance(node, dict) and _CIM_LAYER_KEYS <= set(node)
            and getattr(node["w"], "ndim", 0) >= 2)


def _bank_names(node: Dict) -> list:
    """MoE expert-bank weights inside a dict node: ``nm`` of rank 3 ((E, K,
    N)) or 4 ((L, E, K, N) when stacked) with ``nm_s_w``/``nm_s_p``/
    ``nm_s_a`` siblings."""
    return [nm for nm, v in node.items()
            if getattr(v, "ndim", 0) in (3, 4)
            and all(f"{nm}_{s}" in node for s in _BANK_SCALES)]


def _packed_config(cfg: CIMConfig) -> CIMConfig:
    """Pin a config to a packed backend (deploy by default)."""
    from .backends import get_backend
    if get_backend(cfg.mode).packed:
        return cfg
    return cfg.replace(mode="deploy")


def _pack_each(pack, layer: Dict, cfg: CIMConfig, lead: int, variation=None,
               variation_std=None) -> Dict:
    """Pack a node whose leaves carry ``lead`` leading axes (stacked layers,
    experts) one slice at a time, and stack the results back; with a
    variation source, slice ``i`` (row-major over the leading axes) bakes
    the ``i``-th of ``variation.split(n)``."""
    shape = tuple(layer["w"].shape[:lead])
    flat = {k: v.reshape((-1,) + tuple(v.shape[lead:]))
            for k, v in layer.items()}
    n = flat["w"].shape[0]
    sources = [None] * n if variation is None else variation.split(n)
    outs = [pack({k: v[i] for k, v in flat.items()}, cfg,
                 variation=sources[i], variation_std=variation_std)
            for i in range(n)]
    return {k: torch.stack([o[k] for o in outs]).reshape(
                shape + tuple(outs[0][k].shape))
            for k in outs[0]}


def _pack_bank(node: Dict, nm: str, cfg: CIMConfig, pack_lin,
               variation=None, variation_std=None) -> Dict:
    """Pack one expert bank per expert (and per layer when stacked). The
    outputs keep the flat-key convention, so the router and shared-expert
    siblings stay untouched in the same node."""
    bank = {"w": node[nm].to(torch.float32),
            **{s: node[f"{nm}_{s}"] for s in _BANK_SCALES}}
    packed = _pack_each(pack_lin, bank, cfg, bank["w"].ndim - 2, variation,
                        variation_std)
    out = {f"{nm}_digits": packed["w_digits"],
           f"{nm}_k_logical": packed["k_logical"],
           **{f"{nm}_{s}": packed[s] for s in _BANK_SCALES}}
    if "w_occ" in packed:   # the standard pack; own-pack backends omit it
        out[f"{nm}_occ"] = packed["w_occ"]
    return out


def pack_model(params: Dict, cfg: CIMConfig, *, variation=None,
               variation_std=None, device=None) -> Dict:
    """Walk a model param tree on ``device`` (``cuda`` unless ``"cpu"`` is
    passed), packing every CIM layer and expert bank for deployment with
    ``cfg``'s backend packers. Sequences come back as lists, as in the
    reference. Byte-identical with the reference's ``pack_model``.

    ``variation`` (a variation source, ``core.variation.Sampler``) with a
    sigma ``variation_std`` bakes ONE device realization into float32
    planes: the node at ``path`` draws from ``variation.for_layer(path)``,
    an expert bank ``nm`` from ``for_layer(path + (nm,))``, and a stacked
    node or a bank slice ``i`` from the ``i``-th of that source's
    ``split``, as the reference folds and splits its ``variation_key``."""
    from .backends import packers_for
    pack_lin, pack_cv = packers_for(_packed_config(cfg))
    params = to_device(params, resolve_device(device))

    def source(path):
        return None if variation is None else variation.for_layer(path)

    def walk(node, path):
        if _is_cim_layer(node):
            w = node["w"]
            layer = {k: node[k] for k in _CIM_LAYER_KEYS}
            extras = {k: v for k, v in node.items()
                      if k not in _CIM_LAYER_KEYS}
            kw = dict(variation=source(path), variation_std=variation_std)
            if w.ndim == 2:
                return {**extras, **pack_lin(layer, cfg, **kw)}
            if w.ndim == 4:
                return {**extras, **pack_cv(layer, cfg, **kw)}
            if w.ndim in (3, 5):        # stacked layers: one at a time
                pack = pack_lin if w.ndim == 3 else pack_cv
                return {**extras, **_pack_each(pack, layer, cfg, 1, **kw)}
            raise ValueError(f"CIM layer at {'/'.join(path)} has "
                             f"unsupported weight rank {w.ndim}")
        if isinstance(node, dict):
            out: Dict = {}
            consumed = set()
            for nm in _bank_names(node):
                out.update(_pack_bank(node, nm, cfg, pack_lin,
                                      source(path + (nm,)), variation_std))
                consumed |= {nm, *(f"{nm}_{s}" for s in _BANK_SCALES)}
            for k, v in node.items():
                if k not in consumed:
                    out[k] = walk(v, path + (k,))
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return node
    return walk(params, ())


def col_shard_axes(packed: Dict) -> Dict[str, int]:
    """Every packed CIM node ('/'-joined tree path; expert banks as
    path/<bank name>) -> the axis its digit planes shard over for
    column-parallel serving: always the last."""
    out: Dict[str, int] = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "w_digits" in node:
                out["/".join(path)] = -1
                return
            for k in node:
                if k.endswith("_digits"):
                    out["/".join(path + (k[: -len("_digits")],))] = -1
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
    walk(packed, ())
    return out


@dataclasses.dataclass(frozen=True)
class DeployArtifact:
    """Packed deployment state: digit planes, scales, the config that
    produced them (pinned to a packed backend) and a layout version.
    ``forward(x, artifact.params, artifact.config)`` is the served path
    with no further mode surgery."""

    kind: str                              # linear | conv | model
    config: CIMConfig
    params: Dict[str, Any]
    layout_version: int = ARTIFACT_LAYOUT_VERSION
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown artifact kind {self.kind!r}; "
                             f"valid: {_KINDS}")
        from .backends import get_backend
        if not get_backend(self.config.mode).packed:
            raise ValueError(
                f"DeployArtifact.config must name a packed backend, got "
                f"mode={self.config.mode!r}; use config.replace("
                "mode='deploy') (model_artifact does this for you)")

    def save(self, path: str) -> str:
        """Write the artifact, leaves bit for bit. ``artifact.json`` lands
        last (fsynced, then renamed), so its presence marks a complete
        artifact; an existing header is removed before the new params
        land, so an interrupted overwrite never pairs new params with an
        old header. A column-sharded artifact is gathered first (a
        collective: every rank calls ``save``), rank 0 writes, and every
        rank returns once the files are complete."""
        if any(colshard.is_col_sharded(v) for v in tree_leaves(self.params)):
            import torch.distributed as dist
            full = dataclasses.replace(self, params=colshard.full_tree(
                self.params))
            if dist.get_rank() == 0:
                full.save(path)
            dist.barrier()
            return path
        os.makedirs(path, exist_ok=True)
        jpath = os.path.join(path, "artifact.json")
        if os.path.exists(jpath):
            os.remove(jpath)
        _ckpt.save(path, 0, _mark_int4(self.params, self.config))
        head = {
            "format": _FORMAT,
            "layout_version": self.layout_version,
            "kind": self.kind,
            "backend": self.config.mode,
            "config": dataclasses.asdict(self.config),
            "meta": self.meta,
        }
        tmp = jpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(head, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, jpath)
        return path

    @classmethod
    def load(cls, path: str, *, mesh=None, mesh_axis: str = "model",
             device=None) -> "DeployArtifact":
        """Read an artifact back bit for bit, leaves on ``device`` (``cuda``
        unless ``"cpu"``); layouts 1-3 are migrated to layout 4 in
        memory. With ``mesh``, the leaves are read on the host and placed
        as ``shard`` places them: only this rank's columns of a sharded
        node reach ``device``."""
        jpath = os.path.join(path, "artifact.json")
        if not os.path.exists(jpath):
            raise FileNotFoundError(
                f"{path} is not a DeployArtifact (no artifact.json)")
        with open(jpath) as f:
            head = json.load(f)
        version = head.get("layout_version")
        if version is None or version > ARTIFACT_LAYOUT_VERSION:
            raise ArtifactVersionError(
                f"artifact at {path}", "layout_version", version,
                ARTIFACT_LAYOUT_VERSION, writers=_LAYOUT_WRITERS,
                detail="Upgrade the library or re-pack the artifact.")
        meta = dict(head.get("meta", {}))
        dv = meta.get("delta_version")
        if dv is not None and dv > SCALE_DELTA_VERSION:
            raise ArtifactVersionError(
                f"artifact at {path} (recalibrated)", "delta_version", dv,
                SCALE_DELTA_VERSION, writers=_DELTA_WRITERS,
                detail="Upgrade the library or re-fit the ScaleDelta.")
        try:
            cfg = CIMConfig(**head["config"])
        except ValueError as e:
            if "unknown CIM mode" not in str(e):
                raise
            from .backends import registered_backends
            backend = head.get("backend", head["config"].get("mode"))
            raise ValueError(
                f"artifact at {path} was packed for backend {backend!r}, "
                f"which is not registered in this session (registered: "
                f"{registered_backends()}). Import or register_backend() "
                f"the backend that owns this hardware style before "
                f"loading.") from None
        params = _ckpt.restore_tree(
            path, step=0, device="cpu" if mesh is not None else device)
        if version < 4:
            params = _migrate_pre_v4(params, cfg)
            version = ARTIFACT_LAYOUT_VERSION
        art = cls(kind=head["kind"], config=cfg, params=params,
                  layout_version=version, meta=meta)
        if mesh is not None:
            art = art.shard(mesh, mesh_axis=mesh_axis, device=device)
        return art

    def shard(self, mesh, *, mesh_axis: str = "model",
              device=None) -> "DeployArtifact":
        """Place the packed params on this rank of ``mesh`` (on ``device``,
        ``cuda`` unless ``"cpu"``): each CIM node whose columns divide the
        ranks along ``mesh_axis`` holds its digit planes and column-length
        leaves as sharded leaves of this rank's columns (the layout the
        column-parallel dispatch reads in place); ragged nodes and every
        other leaf whole. A mesh of one rank places everything whole."""
        colshard.check_mesh(mesh, mesh_axis)
        dev = resolve_device(device)
        n_dev = colshard.mesh_shards(mesh, mesh_axis)

        def place(node):
            if isinstance(node, dict):
                if n_dev > 1 and any(k.endswith("_digits") for k in node):
                    return _shard_node(node, mesh, mesh_axis, n_dev, dev,
                                       place)
                return {k: place(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [place(v) for v in node]
            return _on(node, dev)
        return dataclasses.replace(self, params=place(self.params))


def _on(leaf, dev):
    return leaf.to(dev) if isinstance(leaf, torch.Tensor) else leaf


def _shard_node(node: Dict, mesh, mesh_axis: str, n_dev: int, dev,
                place) -> Dict:
    """Place one packed CIM node: a leaf carrying its bank's column axis
    (last dim == the planes' column count) is sharded when the columns
    divide ``n_dev``; everything else stays whole. A quartet node has one
    bank (``w_digits`` owning the unprefixed scales); an MoE node several
    (``wg_digits`` owning ``wg_s_w``, ...). Sub-dict siblings (router,
    shared experts) recurse through ``place``."""
    banks = {k[: -len("_digits")]: int(node[k].shape[-1])
             for k in node if k.endswith("_digits")}

    def bank_cols(k):
        for nm, n in banks.items():
            if k == f"{nm}_digits" or (nm != "w" and k.startswith(f"{nm}_")):
                return n
        return banks.get("w")   # quartet: unprefixed scale keys

    out = {}
    for k, v in node.items():
        if isinstance(v, (dict, list, tuple)):
            out[k] = place(v)
            continue
        n = bank_cols(k)
        if (n is not None and isinstance(v, torch.Tensor) and v.ndim >= 1
                and v.shape[-1] == n and n % n_dev == 0):
            out[k] = colshard.shard_leaf(v, mesh, mesh_axis, device=dev)
        else:
            out[k] = _on(v, dev)
    return out



def model_artifact(params: Dict, cfg: CIMConfig, *,
                   meta: Optional[Dict[str, Any]] = None, variation=None,
                   variation_std=None, device=None) -> DeployArtifact:
    """``pack_model`` wrapped into a model ``DeployArtifact`` (with
    ``variation``/``variation_std``, one baked device realization); the
    shardable column axis of every packed node goes into
    ``meta["col_shard"]``."""
    packed = pack_model(params, cfg, variation=variation,
                        variation_std=variation_std, device=device)
    m = {**(meta or {}), "col_shard": col_shard_axes(packed)}
    return DeployArtifact(kind="model", config=_packed_config(cfg),
                          params=packed, meta=m)
