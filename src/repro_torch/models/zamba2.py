"""Zamba2 hybrid of the port (counterpart of ``repro.models.zamba2``,
arXiv:2411.15242): a Mamba2 backbone with a shared transformer block (one
set of attention + MLP weights) applied after every ``attn_every`` Mamba2
layers. The sharing is genuine: one parameter set at several depths, each
application with its own KV cache at decode. On ``deploy`` every
application launches the CIM matmul kernel on the same packed planes, so
``kernels/relaid.py`` keeps one relaid copy of them.

Decode writes the caches in place: the Mamba2 ``conv`` and ``ssd`` states
(``copy_``) and the shared block's K/V rows (``layers._write_at``), so a
decode step can be captured in a CUDA graph; the returned cache holds the
same tensors and the advanced lengths.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core import colshard
from repro_torch.nn.linear import apply_linear, linear_specs
from repro_torch.nn.module import ParamSpec, stack_specs

from .layers import (apply_mlp, apply_norm, cache_leaf, cdt, check_rows,
                     gqa_attend, gqa_specs, kv_cache, mlp_specs, norm_specs,
                     pdt)
from .mamba2 import apply_mamba2, mamba2_specs, state_leaves
from .transformer import _layer, _layers, check_overrun, embed_lookup


def _n_attn(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def specs(cfg: ModelConfig) -> Dict:
    sp: Dict = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), pdt(cfg), "normal:0.02",
                           ("vocab", "embed")),
        "ln_f": norm_specs(cfg),
        "mamba_layers": stack_specs(mamba2_specs(cfg), cfg.n_layers),
        "lm_head": linear_specs(cfg.d_model, cfg.vocab, in_axis="embed",
                                out_axis="vocab", dtype=pdt(cfg),
                                init="normal:0.02"),
    }
    if cfg.attn_every:
        sp["shared_attn"] = {                 # ONE weight set, reused
            "ln1": norm_specs(cfg),
            "attn": gqa_specs(cfg),
            "ln2": norm_specs(cfg),
            "mlp": mlp_specs(cfg),
        }
    return sp


def _shared_block(p, x, cfg, positions, cache):
    h, nc = gqa_attend(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                       positions=positions, cache=cache)
    x = x + h
    x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return x, nc


def _run(params, x, cfg: ModelConfig, positions, states):
    """Groups of ``attn_every`` Mamba2 layers, the shared block after each
    group (the reference's ``_run``: n_layers // attn_every groups).
    With ``states`` every layer's state is written in place and the
    attention caches' K/V rows too; returns (x, the caches with the
    advanced lengths)."""
    every = cfg.attn_every or cfg.n_layers
    n_groups = cfg.n_layers // every
    lens = []
    # one unbind per leaf: the backward stacks the layers' gradients once
    mamba = _layers(params["mamba_layers"], cfg.n_layers)
    for g in range(n_groups):
        for i in range(g * every, (g + 1) * every):
            st = None if states is None else _layer(states["mamba"], i)
            x, ns = apply_mamba2(colshard.at_use(mamba[i]), x, cfg, state=st)
            if ns is not None:            # into the cache slice, in place
                # (a placed leaf's local block: the SSD state's heads)
                tree_map(lambda dst, new: colshard.local(dst).copy_(
                    colshard.local(new)), st, ns)
        if "shared_attn" in params:
            c_g = None if states is None else _layer(states["attn"], g)
            x, nc = _shared_block(params["shared_attn"], x, cfg, positions,
                                  c_g)
            if nc is not None:
                lens.append(nc["len"])
    if states is None:
        return x, None
    attn = states["attn"]
    if lens:
        attn = {**attn, "len": torch.stack(lens)}
    return x, {"mamba": states["mamba"], "attn": attn}


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds=None) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens).to(cdt(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run(params, x, cfg, positions, None)
    x = apply_norm(params["ln_f"], x, cfg)
    return apply_linear(params["lm_head"], x, None, compute_dtype=cdt(cfg))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict:
    """Every Mamba2 layer's zero float32 state, stacked on a leading layer
    axis, and each shared-block application's KV cache (K/V in the
    compute dtype), on ``device`` (``cuda`` unless ``"cpu"``); under a
    session mesh every leaf holds its rows over the batch axes where their
    ranks divide ``batch``, the SSD state its heads over ``"model"`` and
    K/V their time over ``"model"`` where its ranks divide them
    (``layers.cache_leaf``, the reference's ``cache_shardings``)."""
    dev = resolve_device(device)
    n_attn = _n_attn(cfg)
    return {
        "mamba": {k: cache_leaf((cfg.n_layers,) + shape, torch.float32, dev,
                                model_dim=None if dim is None else dim + 1)
                  for k, (shape, dim) in state_leaves(cfg, batch).items()},
        "attn": kv_cache(cfg, n_attn, batch, max_len, dev, int8=False),
    }


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step (or a stateful prefill of T tokens): the caches are
    written in place. Eagerly, raises when the shared block's KV caches
    would overrun ``max_len`` (``transformer.check_overrun``; skipped under
    a CUDA-graph capture)."""
    check_rows(cache)
    check_overrun(cache["attn"], tokens)
    x = embed_lookup(params["embed"], tokens).to(cdt(cfg))
    positions = (cache["attn"]["len"][0][:, None].to(torch.long)
                 + torch.arange(tokens.shape[1], device=x.device)[None])
    x, new_cache = _run(params, x, cfg, positions, cache)
    x = apply_norm(params["ln_f"], x, cfg)
    return (apply_linear(params["lm_head"], x, None, compute_dtype=cdt(cfg)),
            new_cache)
