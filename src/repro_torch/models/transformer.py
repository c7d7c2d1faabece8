"""Decoder-only LM of the port (counterpart of ``repro.models.transformer``):
the dense GQA family (llama3, granite, qwen3 with qk-norm, olmo with
non-parametric LN), MLA (deepseek-v3) and the MoE variants (moonshot,
deepseek), one spec/apply pair driven by ``ModelConfig``.

Parameters are stacked on a leading layer axis, as the reference stacks
them for ``lax.scan``; the port runs the stack as a Python loop over
per-layer views, so ``scan_layers`` has no effect. Under ``remat`` a
forward whose residual stream autograd records keeps only each block's
input and recomputes the block in the backward
(``torch.utils.checkpoint``), the reference's ``jax.checkpoint`` policy,
so a train step at published width holds one block's activations at a
time. Decode keeps per-layer caches (K/V in the compute dtype or int8
with scales; MLA's latent cache), stacked the same way and written in
place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device, tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.core import colshard
from repro_torch.nn.linear import apply_linear, linear_specs
from repro_torch.nn.module import ParamSpec, constrain, stack_specs

from .layers import (apply_mlp, apply_moe, apply_norm, cache_leaf, cdt,
                     check_rows, gqa_attend, gqa_specs, kv_cache, mla_attend,
                     mla_specs, mlp_specs, moe_specs, norm_specs, pdt)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, *, moe: bool, dense_d_ff: int = 0) -> Dict:
    sp = {"ln1": norm_specs(cfg), "ln2": norm_specs(cfg),
          "attn": mla_specs(cfg) if cfg.mla is not None else gqa_specs(cfg)}
    if moe:
        sp["moe"] = moe_specs(cfg)
    else:
        sp["mlp"] = mlp_specs(cfg, d_ff=dense_d_ff or cfg.d_ff)
    return sp


def specs(cfg: ModelConfig) -> Dict:
    sp: Dict = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), pdt(cfg), "normal:0.02",
                           ("vocab", "embed")),
        "ln_f": norm_specs(cfg),
    }
    if cfg.moe is not None:
        n_dense = cfg.moe.n_dense_layers
        if n_dense:
            sp["dense_layers"] = stack_specs(
                _block_specs(cfg, moe=False,
                             dense_d_ff=cfg.moe.dense_d_ff or cfg.d_ff),
                n_dense)
        sp["moe_layers"] = stack_specs(_block_specs(cfg, moe=True),
                                       cfg.n_layers - n_dense)
    else:
        sp["layers"] = stack_specs(_block_specs(cfg, moe=False), cfg.n_layers)
    if not cfg.tie_embeddings:
        sp["lm_head"] = linear_specs(
            cfg.d_model, cfg.vocab,
            cim=cfg.cim if cfg.cim_lm_head else None,
            in_axis="embed", out_axis="vocab", dtype=pdt(cfg),
            init="normal:0.02")
    return sp


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block(p: Dict, x, cfg: ModelConfig, positions, cache, moe: bool):
    # FSDP: this layer's weights gathered over the batch axes here, so a
    # rank holds one layer's at a time (and a remat recompute gathers
    # them again, in the same order on every rank)
    p = colshard.unshard_tree(p)
    attend = mla_attend if cfg.mla is not None else gqa_attend
    h, new_cache = attend(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                          positions=positions, cache=cache)
    x = x + h
    z = apply_norm(p["ln2"], x, cfg)
    x = x + (apply_moe(p["moe"], z, cfg) if moe else
             apply_mlp(p["mlp"], z, cfg))
    return constrain(x, ("batch", None, None)), new_cache


def _layer(tree, i: int):
    """Layer ``i``'s slice (views) of a stacked tree (tuples and lists of
    stacks come back as tuples)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_layer(v, i) for v in tree)
    return colshard.select(tree, i)


def _layers(tree, n: int):
    """The ``n`` layer slices of a stacked tree, as ``_layer`` gives them,
    through one ``torch.unbind`` per leaf: its backward stacks the
    layers' gradients once, where a slice per layer would put each
    layer's gradient into a zero tensor of the whole stack."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [_layers(v, n) for v in tree]
        return [tuple(p[i] for p in per) for i in range(n)]
    return colshard.unbind(tree)


def _first_leaf(tree):
    """The first leaf of a tree (an empty node, such as olmo's
    non-parametric norms, is skipped)."""
    return next(iter(tree_leaves(tree)))


def _remat_block(p: Dict, x, cfg: ModelConfig, positions, moe: bool):
    return _block(p, x, cfg, positions, None, moe)[0]


def _run_stack(layer_params, x, cfg, positions, caches, moe: bool):
    """A homogeneous stack of blocks, one layer after the other. Each
    layer's cache slice is written in place; the returned caches hold the
    same K/V tensors and the advanced lengths. Without caches, under
    ``cfg.remat`` and with autograd recording the residual stream (a train
    step), each block is recomputed in the backward."""
    n = _first_leaf(layer_params).shape[0]
    remat = cfg.remat and caches is None and x.requires_grad
    lens = []
    for i, p_i in enumerate(_layers(layer_params, n)):
        if remat:
            # a block draws no random numbers: no RNG state to replay
            x = checkpoint(_remat_block, p_i, x, cfg, positions, moe,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        c_i = None if caches is None else _layer(caches, i)
        x, nc = _block(p_i, x, cfg, positions, c_i, moe)
        if nc is not None:
            lens.append(nc["len"])
    if caches is None:
        return x, None
    return x, {**caches, "len": torch.stack(lens)}


def embed_lookup(table, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the (vocab, d) ``table`` at ``tokens``. A table placed over
    ``"model"`` on its vocab (``nn.module.shard_params``) is looked up
    vocab-parallel: each rank gathers the rows it holds, zero elsewhere,
    and one sum over ``"model"`` (``colshard.psum``) adds them, exactly
    (one nonzero term each). FSDP's split of ``d`` is gathered first."""
    table = colshard.unshard_batch(table)
    idx = tokens.to(torch.long)
    if colshard.model_dim(table) is None:
        return colshard.whole(table)[idx]
    if colshard.model_dim(table) != 0:
        raise ValueError("an embedding table is placed over 'model' on its "
                         f"vocab, got {table.placements}")
    mesh, loc = table.device_mesh, table.to_local()
    lo = colshard.mesh_coord(mesh, "model") * loc.shape[0]
    mine = (idx >= lo) & (idx < lo + loc.shape[0])
    rows = loc[torch.where(mine, idx - lo, 0)] * mine[..., None].to(
        loc.dtype)
    return colshard.psum(rows, mesh, ("model",))


def _embed(params, tokens, cfg, extra_embeds):
    x = embed_lookup(params["embed"], tokens).to(cdt(cfg))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cdt(cfg)), x], dim=1)
    return x


def tied_logits(x: torch.Tensor, table, dtype) -> torch.Tensor:
    """x (B, T, d) against the (vocab, d) embedding ``table`` in ``dtype``.
    A table placed over ``"model"`` on its vocab gives this rank's vocab
    columns (per column the single device's product), gathered."""
    table = colshard.unshard_batch(table)
    if colshard.model_dim(table) == 0:
        mesh = table.device_mesh
        y = colshard.col_matmul(x, table.to_local().to(dtype).t(), mesh,
                                ("model",))
        return colshard.gather(y, mesh, ("model",), -1)
    return torch.einsum("btd,vd->btv", x, colshard.whole(table).to(dtype))


def _logits(params, x, cfg):
    x = apply_norm(params["ln_f"], x, cfg)
    if cfg.tie_embeddings:
        return tied_logits(x, params["embed"], cdt(cfg))
    return apply_linear(params["lm_head"], x,
                        cfg.cim if cfg.cim_lm_head else None,
                        compute_dtype=cdt(cfg))


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward: tokens (B, T) -> logits (B, T', vocab);
    extra_embeds (B, Tp, D) are prepended."""
    x = _embed(params, tokens, cfg, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.moe is not None:
        if "dense_layers" in params:
            x, _ = _run_stack(params["dense_layers"], x, cfg, positions, None,
                              False)
        x, _ = _run_stack(params["moe_layers"], x, cfg, positions, None, True)
    else:
        x, _ = _run_stack(params["layers"], x, cfg, positions, None, False)
    return _logits(params, x, cfg)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict:
    """Per-layer decode caches, stacked on a leading layer axis, on
    ``device`` (``cuda`` unless ``"cpu"``): K/V in the compute dtype, or
    with ``kv_cache_dtype="int8"`` int8 codes and float32 per-(token,
    head) scales (``layers.kv_cache``); MLA's latent ``ckv`` and rotary
    key ``krope`` in the compute dtype. Under a session mesh every leaf
    holds its rows over the batch axes where their ranks divide ``batch``,
    and K/V, their scales, ``ckv`` and ``krope`` hold their time over
    ``"model"`` where its ranks divide ``max_len`` (``layers.cache_leaf``,
    the reference's ``cache_shardings``)."""
    dev = resolve_device(device)

    def kv(n_layers):
        return kv_cache(cfg, n_layers, batch, max_len, dev,
                        int8=cfg.kv_cache_dtype == "int8")

    def mla(n_layers):
        m = cfg.mla
        return {"ckv": cache_leaf((n_layers, batch, max_len, m.kv_lora_rank),
                                  cdt(cfg), dev, model_dim=2),
                "krope": cache_leaf((n_layers, batch, max_len, 1,
                                     m.qk_rope_dim), cdt(cfg), dev,
                                    model_dim=2),
                "len": cache_leaf((n_layers, batch), torch.int32, dev)}
    make = mla if cfg.mla is not None else kv
    if cfg.moe is not None:
        n_dense = cfg.moe.n_dense_layers
        out = {"moe_layers": make(cfg.n_layers - n_dense)}
        if n_dense:
            out["dense_layers"] = make(n_dense)
        return out
    return {"layers": make(cfg.n_layers)}


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig, extra_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: tokens (B, T) and the caches -> (logits (B, T, V),
    caches); ``extra_embeds`` (B, Tp, D) are prepended, as ``forward``
    prepends them (llava's image prefill: logits (B, Tp + T, V)). The
    caches are written in place. Eagerly, raises when the T
    new positions would overrun ``max_len``. Under a CUDA-graph capture
    the check would read the lengths back and end the capture, so it is
    skipped and the step syncs nothing: it can be captured once and
    replayed, and a replay past ``max_len`` writes as the reference's
    ``dynamic_update_slice`` does, at the start clamped to ``max_len - T``
    in ``layers._write_at``. A cache holding its rows over the batch axes
    raises (``layers.check_rows``): the serve cell's step runs it."""
    check_rows(cache)
    check_overrun(next(iter(cache.values())), tokens,
                  0 if extra_embeds is None else extra_embeds.shape[1])
    return _decode_step(params, cache, tokens, cfg, extra_embeds)


def check_overrun(stack: Dict, tokens: torch.Tensor, extra: int = 0
                  ) -> None:
    """Raise when T = tokens.shape[1] (+ ``extra`` prepended) new positions
    would overrun a stacked attention cache ({"k" or "ckv", "len"},
    (layers, B, max_len, ...)). Skipped under a CUDA-graph capture, where
    reading the lengths back would end it, and on a ``meta`` cache (the
    dry run's), which holds no lengths to read."""
    t = tokens.shape[1] + extra
    max_len = stack["ckv" if "ckv" in stack else "k"].shape[2]
    if tokens.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    if colshard.local(stack["len"]).is_meta:
        return
    if stack["len"].numel() and int(stack["len"].max()) + t > max_len:
        raise ValueError(f"decode cache overrun: {t} new positions at length "
                         f"{int(stack['len'].max())} exceed max_len "
                         f"{max_len}")


def _decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                 cfg: ModelConfig, extra_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """``decode_step`` below its host check: the write past ``max_len``
    clamps as the reference's does."""
    x = _embed(params, tokens, cfg, extra_embeds)
    first = next(iter(cache.values()))
    t = x.shape[1]
    positions = (first["len"][0][:, None].to(torch.long)
                 + torch.arange(t, device=x.device)[None])
    new_cache: Dict = {}
    if cfg.moe is not None:
        if "dense_layers" in params:
            x, new_cache["dense_layers"] = _run_stack(
                params["dense_layers"], x, cfg, positions,
                cache["dense_layers"], False)
        x, new_cache["moe_layers"] = _run_stack(
            params["moe_layers"], x, cfg, positions, cache["moe_layers"], True)
    else:
        x, new_cache["layers"] = _run_stack(params["layers"], x, cfg,
                                            positions, cache["layers"], False)
    return _logits(params, x, cfg), new_cache
