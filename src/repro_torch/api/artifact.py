"""Whole-model packing and the in-memory deploy artifact (counterpart of
``repro.api.artifact``).

``pack_model`` packs every dict node carrying the CIM-layer quartet {w,
s_w, s_p, s_a}: linear for a 2-D ``w``, conv for a 4-D HWIO ``w``, and
their stacked (scan-over-layers) forms, rank 3 and rank 5, one layer at a
time. MoE expert banks -- flat ``nm``/``nm_s_w``/``nm_s_p``/``nm_s_a``
keys with leading (layer, expert) axes -- pack per expert into
``nm_digits`` planes with ``nm_occ``, ``nm_k_logical`` and per-expert
scales. Every other node (embeddings, norms, routers, full-precision
stems, BatchNorm) passes through.

``DeployArtifact`` is the in-memory unit a server loads: the packed tree,
the ``CIMConfig`` pinned to a packed backend, the layout version and
``meta`` (``meta["col_shard"]`` from ``col_shard_axes``). Saving and
loading it, sharding it and migrating older layouts come with ROADMAP
queue 1, item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device, to_device
from repro_torch.core.cim_linear import CIMConfig

#: Artifact layout of the reference this port writes: int4 planes
#: nibble-packed, a ``w_occ`` occupancy map beside every standard plane.
ARTIFACT_LAYOUT_VERSION = 4

_KINDS = ("linear", "conv", "model")
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


def _pack_each(pack, layer: Dict, cfg: CIMConfig, lead: int) -> Dict:
    """Pack a node whose leaves carry ``lead`` leading axes (stacked layers,
    experts) one slice at a time, and stack the results back."""
    shape = tuple(layer["w"].shape[:lead])
    flat = {k: v.reshape((-1,) + tuple(v.shape[lead:]))
            for k, v in layer.items()}
    outs = [pack({k: v[i] for k, v in flat.items()}, cfg)
            for i in range(flat["w"].shape[0])]
    return {k: torch.stack([o[k] for o in outs]).reshape(
                shape + tuple(outs[0][k].shape))
            for k in outs[0]}


def _pack_bank(node: Dict, nm: str, cfg: CIMConfig, pack_lin) -> Dict:
    """Pack one expert bank per expert (and per layer when stacked). The
    outputs keep the flat-key convention, so the router and shared-expert
    siblings stay untouched in the same node."""
    bank = {"w": node[nm].to(torch.float32),
            **{s: node[f"{nm}_{s}"] for s in _BANK_SCALES}}
    packed = _pack_each(pack_lin, bank, cfg, bank["w"].ndim - 2)
    out = {f"{nm}_digits": packed["w_digits"],
           f"{nm}_k_logical": packed["k_logical"],
           **{f"{nm}_{s}": packed[s] for s in _BANK_SCALES}}
    if "w_occ" in packed:   # the standard pack; own-pack backends omit it
        out[f"{nm}_occ"] = packed["w_occ"]
    return out


def pack_model(params: Dict, cfg: CIMConfig, *, device=None) -> Dict:
    """Walk a model param tree on ``device`` (``cuda`` unless ``"cpu"`` is
    passed), packing every CIM layer and expert bank for deployment with
    ``cfg``'s backend packers. Sequences come back as lists, as in the
    reference. Byte-identical with the reference's ``pack_model``."""
    from .backends import packers_for
    pack_lin, pack_cv = packers_for(_packed_config(cfg))
    params = to_device(params, resolve_device(device))

    def walk(node, path):
        if _is_cim_layer(node):
            w = node["w"]
            layer = {k: node[k] for k in _CIM_LAYER_KEYS}
            extras = {k: v for k, v in node.items()
                      if k not in _CIM_LAYER_KEYS}
            if w.ndim == 2:
                return {**extras, **pack_lin(layer, cfg)}
            if w.ndim == 4:
                return {**extras, **pack_cv(layer, cfg)}
            if w.ndim in (3, 5):        # stacked layers: one at a time
                pack = pack_lin if w.ndim == 3 else pack_cv
                return {**extras, **_pack_each(pack, layer, cfg, 1)}
            raise ValueError(f"CIM layer at {'/'.join(path)} has "
                             f"unsupported weight rank {w.ndim}")
        if isinstance(node, dict):
            out: Dict = {}
            consumed = set()
            for nm in _bank_names(node):
                out.update(_pack_bank(node, nm, cfg, pack_lin))
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


def model_artifact(params: Dict, cfg: CIMConfig, *,
                   meta: Optional[Dict[str, Any]] = None,
                   device=None) -> DeployArtifact:
    """``pack_model`` wrapped into a model ``DeployArtifact``; the shardable
    column axis of every packed node goes into ``meta["col_shard"]``."""
    packed = pack_model(params, cfg, device=device)
    m = {**(meta or {}), "col_shard": col_shard_axes(packed)}
    return DeployArtifact(kind="model", config=_packed_config(cfg),
                          params=packed, meta=m)
