"""The port's side of the ResNet cells: its config and parameter trees
built from a configuration file and the benchmark's raw weights. Every
derived quantity (the LSQ weight scales, calibration, BN statistics,
packing) is left to the port's own entry points."""
from __future__ import annotations

from typing import Dict

import torch

from .. import counts


def port_config(config: dict):
    """(ResNetConfig in emulate mode, its CIMConfig)."""
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.models.resnet import ResNetConfig
    c = config["cim"]
    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=c["weight_bits"],
                    cell_bits=c["cell_bits"], act_bits=c["act_bits"],
                    psum_bits=c["psum_bits"], array_rows=c["array_rows"],
                    array_cols=c["array_cols"],
                    weight_granularity=c["weight_granularity"],
                    psum_granularity=c["psum_granularity"],
                    act_signed=c["act_signed"], pack_dtype=c["pack_dtype"])
    cfg = ResNetConfig(name=f"resnet{config['depth']}",
                       depth=config["depth"], n_classes=config["n_classes"],
                       widths=tuple(config["stage_widths"]),
                       in_hw=config["in_hw"], cim=cim,
                       bn_momentum=config["bn_momentum"])
    if (list(cfg.stage_widths) != config["stage_widths"]
            or cfg.blocks_per_stage != config["blocks_per_stage"]):
        raise ValueError(f"the port's ResNet-{config['depth']} is not the "
                         f"configuration's: widths {cfg.stage_widths}, "
                         f"{cfg.blocks_per_stage} blocks a stage")
    return cfg, cim


def port_params(raw: Dict[str, torch.Tensor], config: dict, cim):
    """(params, BN state) in the port's tree layout around the raw weights:
    each CIM conv's LSQ weight scale from the port's own init rule, its
    activation and partial-sum scales left for calibration, BN affine
    at (1, 0) and statistics at (0, 1)."""
    from repro_torch.core.cim_conv import conv_weight_scales_from

    def bn(c: int):
        dev = raw["fc.b"].device
        return ({"scale": torch.ones(c, device=dev),
                 "bias": torch.zeros(c, device=dev)},
                {"mean": torch.zeros(c, device=dev),
                 "var": torch.ones(c, device=dev)})

    def cim_layer(w):
        return {"w": w, "s_w": conv_weight_scales_from(w, cim),
                "s_p": torch.ones((1, 1, 1), device=w.device),
                "s_a": torch.ones((1,), device=w.device)}

    params: Dict = {"stem": {"w": raw["stem"]}}
    state: Dict = {}
    params["stem_bn"], state["stem_bn"] = bn(config["stage_widths"][0])
    for name, w, _, proj in counts.blocks(config):
        blk: Dict = {"conv1": cim_layer(raw[f"{name}.conv1"]),
                     "conv2": cim_layer(raw[f"{name}.conv2"])}
        bst: Dict = {}
        blk["bn1"], bst["bn1"] = bn(w)
        blk["bn2"], bst["bn2"] = bn(w)
        if proj:
            blk["proj"] = cim_layer(raw[f"{name}.proj"])
            blk["bn_p"], bst["bn_p"] = bn(w)
        params[name], state[name] = blk, bst
    params["fc"] = {"w": raw["fc.w"], "b": raw["fc.b"]}
    return params, state
