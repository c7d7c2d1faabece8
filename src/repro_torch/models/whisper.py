"""Whisper-style encoder-decoder of the port (counterpart of
``repro.models.whisper``, arXiv:2212.04356).

Encoder: bidirectional self-attention over frames and learned positions.
Decoder: causal self-attention (KV-cached) and cross-attention to the
encoder output. As in the reference, the cross-attention's K/V are
recomputed from ``enc_out`` at every decode step (its ``_dec_block`` calls
``gqa_attend`` over ``x_kv`` without a cache, though its docstring says
they are cached).

Front end: with ``cfg.conv_frontend`` the two-conv stem (GELU(conv k=3),
then GELU(conv k=3, stride 2)) runs on raw log-mel frames (B,
2 * n_frontend_tokens, n_mels = frontend_dim) through the CIM conv path,
time as the W axis of an H = 1 NHWC image; on ``deploy`` each conv is one
launch of the implicit-GEMM conv kernel. Stub inputs (precomputed (B,
n_frames, d_model) frame embeddings) bypass the stem, keyed on the
trailing dim.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import colshard
from repro_torch.nn.module import ParamSpec, stack_specs

from .layers import (apply_conv, apply_mlp, apply_norm, cache_leaf, cdt,
                     check_rows, conv_specs, gqa_attend, gqa_specs, kv_cache,
                     mlp_specs, norm_specs, pdt)
from .transformer import (_layer, _layers, check_overrun, embed_lookup,
                          tied_logits)


def _enc_block_specs(cfg):
    return {"ln1": norm_specs(cfg), "attn": gqa_specs(cfg),
            "ln2": norm_specs(cfg), "mlp": mlp_specs(cfg)}


def _dec_block_specs(cfg):
    return {"ln1": norm_specs(cfg), "self_attn": gqa_specs(cfg),
            "ln2": norm_specs(cfg), "cross_attn": gqa_specs(cfg),
            "ln3": norm_specs(cfg), "mlp": mlp_specs(cfg)}


def specs(cfg: ModelConfig) -> Dict:
    sp = {
        "enc_pos": ParamSpec((cfg.n_frontend_tokens, cfg.d_model), pdt(cfg),
                             "normal:0.01", (None, "embed")),
        "enc_layers": stack_specs(_enc_block_specs(cfg), cfg.enc_layers),
        "enc_ln_f": norm_specs(cfg),
        "embed": ParamSpec((cfg.vocab, cfg.d_model), pdt(cfg), "normal:0.02",
                           ("vocab", "embed")),
        "dec_pos": ParamSpec((cfg.max_seq, cfg.d_model), pdt(cfg),
                             "normal:0.01", (None, "embed")),
        "dec_layers": stack_specs(_dec_block_specs(cfg), cfg.n_layers),
        "dec_ln_f": norm_specs(cfg),
    }
    if cfg.conv_frontend:
        n_mels = cfg.frontend_dim or cfg.d_model
        sp["frontend"] = {
            "conv1": conv_specs(1, 3, n_mels, cfg.d_model, cim=cfg.cim,
                                out_axis="embed"),
            "conv2": conv_specs(1, 3, cfg.d_model, cfg.d_model, cim=cfg.cim,
                                out_axis="embed"),
        }
    return sp


def _gelu(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """jax.nn.gelu (the tanh form) in float32, back to the compute dtype."""
    return F.gelu(h.to(torch.float32), approximate="tanh").to(cdt(cfg))


def _conv_stem(params: Dict, mel: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Raw log-mel (B, 2F, n_mels) -> (B, F, d_model) through the conv
    stem (time is the W axis of an H = 1 image; conv2's stride 2 halves
    the frame rate)."""
    h = mel.to(cdt(cfg))[:, None]                        # (B, 1, 2F, mels)
    h = apply_conv(params["frontend"]["conv1"], h, cfg.cim, stride=1,
                   padding="SAME", compute_dtype=cdt(cfg))
    h = apply_conv(params["frontend"]["conv2"], _gelu(h, cfg), cfg.cim,
                   stride=2, padding="SAME", compute_dtype=cdt(cfg))
    return _gelu(h, cfg)[:, 0]


def encode(params: Dict, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: raw log-mel (B, 2F, n_mels) when the conv front end is on
    (trailing dim != d_model), else stub embeddings (B, F, d) -> the
    encoder states (B, F, d)."""
    if cfg.conv_frontend and frames.shape[-1] != cfg.d_model:
        frames = _conv_stem(params, frames, cfg)
    x = (frames.to(cdt(cfg))
         + params["enc_pos"][None, :frames.shape[1]].to(cdt(cfg)))
    positions = torch.arange(x.shape[1], device=x.device)
    for p in _layers(params["enc_layers"], cfg.enc_layers):
        h, _ = gqa_attend(p["attn"], apply_norm(p["ln1"], x, cfg), cfg,
                          positions=positions, causal=False)
        x = x + h
        x = x + apply_mlp(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    return apply_norm(params["enc_ln_f"], x, cfg)


def _dec_block(p, x, cfg, positions, enc_out, cache):
    h, nc = gqa_attend(p["self_attn"], apply_norm(p["ln1"], x, cfg), cfg,
                       positions=positions, cache=cache)
    x = x + h
    h, _ = gqa_attend(p["cross_attn"], apply_norm(p["ln2"], x, cfg), cfg,
                      positions=positions, x_kv=enc_out, causal=False)
    x = x + h
    x = x + apply_mlp(p["mlp"], apply_norm(p["ln3"], x, cfg), cfg)
    return x, nc


def decode(params: Dict, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelConfig, cache: Optional[Dict] = None,
           position_offset=0):
    """The decoder over ``tokens`` (B, t) with cross-attention to
    ``enc_out``; ``position_offset`` an int or a (B,) tensor of per-row
    offsets. With ``cache`` ({"k", "v", "len"}, stacked per layer) the
    self-attention K/V rows are written in place. Returns (logits through
    the tied embedding, the cache with the advanced lengths or None)."""
    b, t = tokens.shape
    ar = torch.arange(t, device=tokens.device)
    if torch.is_tensor(position_offset) and position_offset.ndim == 1:
        pos_idx = position_offset.to(torch.long)[:, None] + ar[None]
    else:
        pos_idx = position_offset + ar
    x = (embed_lookup(params["embed"], tokens).to(cdt(cfg))
         + colshard.whole(params["dec_pos"])[pos_idx].to(cdt(cfg)))
    lens = []
    for i, p_i in enumerate(_layers(params["dec_layers"], cfg.n_layers)):
        c_i = None if cache is None else _layer(cache, i)
        x, nc = _dec_block(p_i, x, cfg, pos_idx, enc_out, c_i)
        if nc is not None:
            lens.append(nc["len"])
    x = apply_norm(params["dec_ln_f"], x, cfg)
    logits = tied_logits(x, params["embed"], cdt(cfg))
    new_cache = None if cache is None else {**cache,
                                            "len": torch.stack(lens)}
    return logits, new_cache


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced forward: ``extra_embeds`` the encoder's input (raw
    log-mel frames or stub embeddings)."""
    enc_out = encode(params, extra_embeds, cfg)
    logits, _ = decode(params, tokens, enc_out, cfg, cache=None)
    return logits


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict:
    """The decoder's self-attention KV cache (stacked per layer, the
    compute dtype) and a zero ``enc_out`` (B, n_frontend_tokens, d_model)
    the caller replaces with the encoder states, on ``device`` (``cuda``
    unless ``"cpu"``); under a session mesh every leaf holds its rows over
    the batch axes where their ranks divide ``batch``
    (``layers.cache_leaf``)."""
    dev = resolve_device(device)
    return {
        **kv_cache(cfg, cfg.n_layers, batch, max_len, dev, int8=False),
        "enc_out": cache_leaf((batch, cfg.n_frontend_tokens, cfg.d_model),
                              cdt(cfg), dev, row_dim=0),
    }


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step (or a prefill of T tokens) over the cache's
    ``enc_out``; the K/V rows are written in place. Eagerly, raises when
    the T new positions would overrun ``max_len``
    (``transformer.check_overrun``; skipped under a CUDA-graph
    capture)."""
    check_rows(cache)
    sa = {"k": cache["k"], "v": cache["v"], "len": cache["len"]}
    check_overrun(sa, tokens)
    logits, new_sa = decode(params, tokens, cache["enc_out"], cfg, cache=sa,
                            position_offset=cache["len"][0])
    return logits, {**new_sa, "enc_out": cache["enc_out"]}
