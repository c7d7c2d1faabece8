"""Whole-model packing (counterpart of ``repro.api.artifact.pack_model``).

Any dict node carrying the CIM-layer quartet {w, s_w, s_p, s_a} is packed
(linear for a 2-D ``w``, conv for a 4-D HWIO ``w``); every other node --
full-precision stem and FC, BatchNorm -- passes through. The on-disk
``DeployArtifact`` and stacked (scan-over-layers) nodes come with ROADMAP
queue 1, item 7; MoE expert banks with item 10.
"""
from __future__ import annotations

from typing import Dict

from repro_torch import resolve_device, to_device
from repro_torch.core.cim_linear import CIMConfig

_CIM_LAYER_KEYS = frozenset({"w", "s_w", "s_p", "s_a"})
_BANK_SCALES = ("s_w", "s_p", "s_a")


def _is_cim_layer(node) -> bool:
    return (isinstance(node, dict) and _CIM_LAYER_KEYS <= set(node)
            and getattr(node["w"], "ndim", 0) >= 2)


def _bank_names(node: Dict) -> list:
    """MoE expert-bank weights inside a dict node (``nm`` of rank 3/4 with
    ``nm_s_w``/``nm_s_p``/``nm_s_a`` siblings)."""
    return [nm for nm, v in node.items()
            if getattr(v, "ndim", 0) in (3, 4)
            and all(f"{nm}_{s}" in node for s in _BANK_SCALES)]


def _packed_config(cfg: CIMConfig) -> CIMConfig:
    """Pin a config to a packed backend (deploy by default)."""
    from .backends import get_backend
    if get_backend(cfg.mode).packed:
        return cfg
    return cfg.replace(mode="deploy")


def pack_model(params: Dict, cfg: CIMConfig, *, device=None) -> Dict:
    """Walk a model param tree on ``device`` (``cuda`` unless ``"cpu"`` is
    passed), packing every CIM layer for deployment with ``cfg``'s
    backend packers. Sequences come back as lists, as in the reference."""
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
            if w.ndim in (3, 5):
                raise NotImplementedError(
                    f"CIM layer at {'/'.join(path)}: stacked (scan-over-"
                    "layers) weights are not ported yet (ROADMAP queue 1, "
                    "item 7)")
            raise ValueError(f"CIM layer at {'/'.join(path)} has "
                             f"unsupported weight rank {w.ndim}")
        if isinstance(node, dict):
            if _bank_names(node):
                raise NotImplementedError(
                    f"node {'/'.join(path)}: MoE expert banks are not ported "
                    "yet (ROADMAP queue 1, item 10)")
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return node
    return walk(params, ())
