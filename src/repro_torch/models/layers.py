"""Transformer building blocks of the port (counterpart of
``repro.models.layers``): norms, RoPE, GQA attention (full and KV-chunked
online softmax), SwiGLU/GELU MLPs and the MoE block with capacity-bounded
dispatch. Every stored-weight matmul goes through ``apply_linear``, so
the CIM quantization applies uniformly; packed MoE expert banks on the
``deploy`` backend run all experts of a bank in one launch of the batched
CIM experts kernel (``kernels.ops.cim_matmul_experts``).

GQA attention runs with the compute-dtype or the int8 KV cache
(``_kv_quantize``), and as cross-attention over ``x_kv``; MLA attention
(DeepSeek-V3) keeps a latent cache. ``conv_specs``/``apply_conv`` are the
CIM-aware conv layer of the zoo's front ends (whisper's stem, llava's
patch embed): on ``deploy`` one launch of the implicit-GEMM conv kernel
(``kernels.cim_conv``) per conv.

Under a session mesh the parallel layers of the reference run over the
ranks (one process each): the expert-parallel MoE (``_apply_moe_ep``:
each rank's experts, raw banks placed by ``nn.module.shard_params``) and
the sequence-parallel flash decode (``_flash_decode_ep``: a KV cache
time-sharded by ``kv_cache``), each where the reference's predicate
sends it, and the sequence-parallel MLA decode (``_mla_flash_decode``:
the latent cache time-sharded). Every decode cache is placed as the
reference's ``cache_shardings`` places it (``cache_leaf``), and a cache
placed otherwise is refused (``placed_over_model``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.core import colshard
from repro_torch.core.colshard import col_apply
from repro_torch.nn.linear import apply_linear, linear_specs
from repro_torch.nn.module import ParamSpec, constrain

NEG_INF = -1e30


def cdt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def pdt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# conv (CIM-aware entry point, as nn.linear.apply_linear)
# ---------------------------------------------------------------------------

def conv_specs(kh: int, kw: int, c_in: int, c_out: int, *,
               cim=None, out_axis: Optional[str] = None,
               dtype=torch.float32) -> Dict[str, ParamSpec]:
    """ParamSpecs of a CIM conv layer: the HWIO weight and the paper's
    scales. On a packed backend the weight exists only as the 6-D digit
    planes (S, k_tiles, kh, kw, cpa stored, C_out) the fused conv kernel
    reads, in the backend's plane geometry; the standard pack stores int4
    planes nibble-packed on the channel-slice axis and carries a ``w_occ``
    map. ``out_axis`` lands on the planes' last (C_out) axis."""
    from repro_torch.api.backends import (conv_plane_tiling, has_own_pack,
                                          is_packed, plane_bits)
    from repro_torch.core.granularity import Granularity, conv_tiling
    from repro_torch.core.nibble import stored_rows

    if is_packed(cim):
        t, cpa = conv_plane_tiling(cim, kh, kw, c_in, c_out)
        own_pack = has_own_pack(cim)
        if own_pack:
            cpa_s, store = cpa, cim.store_dtype()
        else:
            cpa_s, store = stored_rows(cpa, cim.store_dtype())
        specs = {"w_digits": ParamSpec(
            (t.n_split, t.k_tiles, kh, kw, cpa_s, c_out), store, "zeros",
            (None, None, None, None, None, out_axis))}
        if not own_pack:
            specs["w_occ"] = ParamSpec((t.n_split, t.k_tiles, c_out),
                                       torch.uint8, "zeros",
                                       (None, None, out_axis))
    else:
        # He init over the whole receptive field (kh*kw*c_in), as
        # api.init_conv; the "fan_in" init would see c_in alone
        std = math.sqrt(2.0 / (kh * kw * c_in))

        def he(g, s, d, dev):
            return (torch.randn(tuple(s), generator=g, dtype=torch.float32,
                                device=dev) * std).to(d)
        specs = {"w": ParamSpec((kh, kw, c_in, c_out), dtype, he,
                                (None, None, None, out_axis))}
    if cim is not None and cim.enabled:
        if is_packed(cim) and plane_bits(cim) != (cim.weight_bits,
                                                  cim.cell_bits):
            # plane-geometry backends (binary) store full column scales
            t, _ = conv_plane_tiling(cim, kh, kw, c_in, c_out)
            wg = t.weight_scale_shape(Granularity.COLUMN)
            pg = t.psum_scale_shape(Granularity.COLUMN)
        else:
            t, _ = conv_tiling(kh, kw, c_in, c_out, cim.array_rows,
                               cim.array_cols, cim.weight_bits,
                               cim.cell_bits)
            wg = t.weight_scale_shape(cim.weight_granularity)
            pg = t.psum_scale_shape(cim.psum_granularity)
        specs["s_w"] = ParamSpec(wg, torch.float32, "const:0.05",
                                 (None, out_axis if wg[1] == c_out else None))
        specs["s_p"] = ParamSpec(pg, torch.float32, "const:8.0",
                                 (None, None,
                                  out_axis if pg[2] == c_out else None))
        specs["s_a"] = ParamSpec((1,), torch.float32, "ones", (None,))
    return specs


def apply_conv(params: Dict, x: torch.Tensor, cim=None, *, stride: int = 1,
               padding="SAME", compute_dtype=torch.bfloat16, variation=None,
               variation_std=None) -> torch.Tensor:
    """NHWC conv: the plain conv in ``compute_dtype`` (XLA's SAME/VALID
    pads, ``kernels.ref.conv_pads``) without CIM, else the CIM conv of
    ``cim.mode``'s backend (``api.conv2d``: emulate's grouped conv, or the
    fused conv kernel on ``deploy``). ``variation``/``variation_std``
    evaluate one cell-noise realization."""
    if cim is None or not cim.enabled:
        from repro_torch.core.cim_conv import _forward_conv_off
        return _forward_conv_off(x, params, cim, stride, padding, None, None,
                                 compute_dtype)
    from repro_torch.api import conv2d
    return conv2d(x, params, cim, stride=stride, padding=padding,
                  variation=variation, variation_std=variation_std,
                  compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_specs(cfg: ModelConfig, dim: Optional[int] = None) -> Dict:
    d = dim or cfg.d_model
    if cfg.norm == "nonparam_ln":          # no learnable affine
        return {}
    return {"scale": ParamSpec((d,), torch.float32, "ones", ("embed",))}


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
    else:                                   # rmsnorm
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    if "scale" in p:
        # whole at use: FSDP places a norm scale over the batch axes
        y = y * colshard.whole(p["scale"]).to(torch.float32)
    return y.to(x.dtype)


def head_norm_specs(cfg: ModelConfig, hd: int) -> Dict:
    return {"scale": ParamSpec((hd,), torch.float32, "ones", (None,))}


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm over the last axis with a float32 ``scale``, in float32,
    back to x's dtype."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (y * scale.to(torch.float32)).to(x.dtype)


def apply_head_rmsnorm(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return _rms(x, colshard.whole(p["scale"]))


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x (..., T, H, hd); positions broadcastable to (..., T). Rotates the
    two halves of each head (not interleaved pairs)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs       # (..., T, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core (full + KV-chunked online softmax)
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def _scores(q, k, sc):
    """(B, H, Tq, Tk) float32 scores: the compute-dtype operands are exact
    in float32, the sum accumulates in float32."""
    return torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                        k.to(torch.float32)) * sc


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset=0, kv_len: Optional[torch.Tensor] = None,
              chunk: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention; q (B, Tq, H, hd), k (B, Tk, KvH, hd), v (B, Tk,
    KvH, hdv). An online-softmax loop over KV chunks when ``chunk`` is set
    and Tk > chunk. Masked scores are ``NEG_INF`` (finite), so a fully
    masked row is uniform, not NaN."""
    b, tq, h, hd = q.shape
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    sc = (scale if scale is not None else
          1.0 / torch.sqrt(torch.full((), float(hd), dtype=torch.float32,
                                      device=q.device)))
    tk = k.shape[1]

    if not chunk or tk <= chunk:
        s = _scores(q, k, sc)
        mask = _build_mask(tq, tk, causal, q_offset, kv_len, q.device)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)

    n_chunks = (tk + chunk - 1) // chunk
    pad = n_chunks * chunk - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, tq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk]
        vb = v[:, c * chunk:(c + 1) * chunk]
        s = _scores(q, kb, sc)
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        valid = kpos < tk
        if kv_len is not None:
            valid = (valid[None, :] & (kpos[None, :] < kv_len[:, None])
                     )[:, None, None, :]
        else:
            valid = valid[None, None, None, :]
        if causal:
            qpos = _qpos(q_offset, tq, q.device)
            valid = valid & (qpos[:, :, None] >= kpos[None, None, :])[:, None]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype), vb).to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)                # (B, Tq, H, hdv)


def _qpos(q_offset, tq: int, device) -> torch.Tensor:
    """(B, tq) or (1, tq) query positions from a scalar or (B,) offset."""
    off = torch.as_tensor(q_offset, device=device)
    if off.ndim == 0:
        off = off[None]
    return off[:, None] + torch.arange(tq, device=device)[None, :]


def _build_mask(tq, tk, causal, q_offset, kv_len, device):
    parts = []
    kpos = torch.arange(tk, device=device)
    if causal:
        qpos = _qpos(q_offset, tq, device)                    # (B|1, tq)
        parts.append((qpos[:, :, None] >= kpos[None, None, :])[:, None])
    if kv_len is not None:
        parts.append((kpos[None, :] < kv_len[:, None])[:, None, None, :])
    if not parts:
        return None
    mask = parts[0]
    for p in parts[1:]:
        mask = mask & p
    return mask


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig) -> Dict:
    d, h, kvh, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    dt = pdt(cfg)
    sp = {
        "wq": linear_specs(d, h * hd, cim=cfg.cim, in_axis="embed",
                           out_axis="heads", dtype=dt),
        "wk": linear_specs(d, kvh * hd, cim=cfg.cim, in_axis="embed",
                           out_axis="heads", dtype=dt),
        "wv": linear_specs(d, kvh * hd, cim=cfg.cim, in_axis="embed",
                           out_axis="heads", dtype=dt),
        "wo": linear_specs(h * hd, d, cim=cfg.cim, in_axis="heads",
                           out_axis="embed", dtype=dt),
    }
    if cfg.qk_norm:
        sp["q_norm"] = head_norm_specs(cfg, hd)
        sp["k_norm"] = head_norm_specs(cfg, hd)
    return sp


def gqa_attend(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, cache: Optional[Dict] = None,
               causal: bool = True, x_kv: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA self-attention (or cross-attention over ``x_kv``). With a decode
    ``cache`` ({"k", "v", "len"}, or the int8 cache's {"k", "v",
    "k_scale", "v_scale", "len"}) the new K/V rows are written in place at
    each row's ``len`` (``_write_at``) and the query attends over the
    prefix; the returned cache holds the same tensors and ``len + T``.
    The int8 cache stores ``_kv_quantize``'s codes and per-(token, head)
    scales, and the attention reads the whole cache dequantized to the
    compute dtype, as the reference's path without a mesh does. A cache
    placed with its time over ``"model"`` (``kv_cache`` under a session
    mesh) takes the flash decode for one token with ``cfg.flash_decode``
    (``_flash_decode_ep``); else each rank writes the rows it owns and
    the query attends over the cache gathered at use, exactly."""
    b, t, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    src = x if x_kv is None else x_kv
    q = apply_linear(p["wq"], x, cfg.cim, compute_dtype=cdt(cfg)
                     ).reshape(b, t, h, hd)
    k = apply_linear(p["wk"], src, cfg.cim, compute_dtype=cdt(cfg)
                     ).reshape(b, src.shape[1], kvh, hd)
    v = apply_linear(p["wv"], src, cfg.cim, compute_dtype=cdt(cfg)
                     ).reshape(b, src.shape[1], kvh, hd)
    if cfg.qk_norm:
        q = apply_head_rmsnorm(p["q_norm"], q)
        k = apply_head_rmsnorm(p["k_norm"], k)
    if x_kv is None and cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and x_kv is None:
        idx = cache["len"]                                   # (B,) int32
        if "k_scale" in cache:                               # int8 KV cache
            (kq, ks), (vq, vs) = _kv_quantize(k), _kv_quantize(v)
            new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            new = {"k": k, "v": v}
        mesh = placed_over_model(cache["k"], 1)
        if mesh is not None and _flash_decode_ep_ready(
                cfg, t, cache["k"].shape[1], b) is not None:
            out = _flash_decode_ep(q, new, cache, idx, mesh)
        elif mesh is not None:
            # a prefill (T > 1), or a decode step with flash decode off,
            # over the time-sharded cache: each rank writes the rows it
            # owns, and the query attends over the gathered cache as the
            # reference's plain path does (exact)
            start = idx.to(torch.long).clamp(0, cache["k"].shape[1] - t)
            for name, rows in new.items():
                _write_local(cache[name], rows, start)
            k_at, v_at = _dequantized({n: colshard.full_leaf(cache[n])
                                       for n in new}, k.dtype)
            out = attention(q, k_at, v_at, causal=True, q_offset=idx,
                            kv_len=idx + t, chunk=cfg.attn_chunk)
        else:
            rows, cols = _write_at(idx, t, cache["k"])
            for name, val in new.items():
                cache[name][rows, cols] = val.to(cache[name].dtype)
            k_at, v_at = _dequantized(cache, k.dtype)
            out = attention(q, k_at, v_at, causal=True, q_offset=idx,
                            kv_len=idx + t, chunk=cfg.attn_chunk)
        new_cache = {n: cache[n] for n in new}
        new_cache["len"] = idx + t
    else:
        out = attention(q, k, v, causal=causal and x_kv is None,
                        chunk=cfg.attn_chunk)
    y = apply_linear(p["wo"], out.reshape(b, t, h * hd), cfg.cim,
                     compute_dtype=cdt(cfg))
    return y, new_cache


def _write_at(idx: torch.Tensor, t: int, cache: torch.Tensor):
    """(rows, cols) indices of T new positions of each batch row in a
    (B, max_len, ...) cache. As the reference's ``dynamic_update_slice``,
    the write starts at ``len`` clamped to [0, max_len - T], computed on
    the device, so it never leaves the cache (``decode_step`` raises on an
    overrun before it gets here, except under a CUDA-graph capture); the
    attention keeps the unclamped ``len`` as the query offset and
    ``len + T`` as the valid length."""
    dev = cache.device
    rows = torch.arange(cache.shape[0], device=dev)[:, None]
    start = idx.to(torch.long).clamp(0, cache.shape[1] - t)
    return rows, start[:, None] + torch.arange(t, device=dev)[None, :]


def _dequantized(cache: Dict, dtype: torch.dtype):
    """(K, V) to attend over: the int8 cache's codes times their scales in
    ``dtype``, or the compute-dtype cache as it is."""
    if "k_scale" not in cache:
        return cache["k"], cache["v"]
    return tuple((cache[n].to(torch.float32) * cache[f"{n}_scale"][..., None]
                  ).to(dtype) for n in ("k", "v"))


def _kv_quantize(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of K/V rows (the
    reference's ``_kv_quantize``): x (B, T, KvH, hd) -> (int8 codes,
    (B, T, KvH) float32 scales max|x| / 127 + 1e-9); codes round half to
    even and clip to +-127. The division is IEEE's on either device (a
    Python-scalar divisor is a multiply by its reciprocal on CUDA), as the
    reference's code reads; XLA compiles it as a multiply by the float32
    reciprocal fused with the add, which moves some scales by an ulp."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    s = amax / torch.full_like(amax, 127.0) + 1e-9
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3): low-rank Q/KV compression, latent cache
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dt = pdt(cfg)
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": linear_specs(d, m.q_lora_rank, cim=cfg.cim, in_axis="embed",
                             out_axis=None, dtype=dt),
        "q_a_norm": {"scale": ParamSpec((m.q_lora_rank,), torch.float32,
                                        "ones", (None,))},
        "wq_b": linear_specs(m.q_lora_rank, h * qk_dim, cim=cfg.cim,
                             in_axis=None, out_axis="heads", dtype=dt),
        "wkv_a": linear_specs(d, m.kv_lora_rank + m.qk_rope_dim, cim=cfg.cim,
                              in_axis="embed", out_axis=None, dtype=dt),
        "kv_a_norm": {"scale": ParamSpec((m.kv_lora_rank,), torch.float32,
                                         "ones", (None,))},
        "wkv_b": linear_specs(m.kv_lora_rank,
                              h * (m.qk_nope_dim + m.v_head_dim), cim=cfg.cim,
                              in_axis=None, out_axis="heads", dtype=dt),
        "wo": linear_specs(h * m.v_head_dim, d, cim=cfg.cim, in_axis="heads",
                           out_axis="embed", dtype=dt),
    }


def mla_attend(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, cache: Optional[Dict] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA self-attention (the reference's ``mla_attend``). Queries through
    the q low-rank pair (``wq_a``, RMSNorm, ``wq_b``); keys and values
    from the normed latent ``ckv`` through ``wkv_b``, with a shared
    rotary key ``k_rope`` (B, T, 1, r) broadcast over the heads. With a
    decode ``cache`` ({"ckv", "krope", "len"}) the new latent rows are
    written in place (``_write_at``'s clamp) and ``wkv_b`` runs over the
    whole latent cache on every step, as the reference does: it is a CIM
    linear whose partial sums the ADC quantizes per column, so absorbing
    it into the query would be another result.

    A latent cache placed with its time over ``"model"`` (``init_cache``
    under a session mesh, as the reference's ``cache_shardings`` places
    it): a prefill, or a decode step with flash decode off, writes each
    rank's rows (``_write_local``) and runs the plain path on the cache
    gathered whole at use, exactly; one decode token with
    ``cfg.flash_decode`` runs the sequence-parallel MLA decode
    (``_mla_flash_decode``)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    c = cdt(cfg)
    q = apply_linear(p["wq_b"],
                     _rms(apply_linear(p["wq_a"], x, cfg.cim,
                                       compute_dtype=c),
                          p["q_a_norm"]["scale"]),
                     cfg.cim, compute_dtype=c).reshape(b, t, h, qk_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q = torch.cat([q_nope, rope(q_rope, positions, cfg.rope_theta)], dim=-1)

    kv_a = apply_linear(p["wkv_a"], x, cfg.cim, compute_dtype=c)
    ckv, k_rope = kv_a[..., :m.kv_lora_rank], kv_a[..., m.kv_lora_rank:]
    ckv = _rms(ckv, p["kv_a_norm"]["scale"])
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    # the scale in float32, as the reference's jnp.sqrt of a Python float
    scale = 1.0 / torch.sqrt(torch.full((), float(qk_dim),
                                        dtype=torch.float32, device=x.device))

    new_cache, q_offset, kv_len, out = None, 0, None, None
    if cache is not None:
        idx = cache["len"]
        new_cache = {"ckv": cache["ckv"], "krope": cache["krope"],
                     "len": idx + t}
        q_offset, kv_len = idx, idx + t
        mesh = placed_over_model(cache["ckv"], 1)
        if mesh is not None and _flash_decode_ep_ready(
                cfg, t, cache["ckv"].shape[1], b) is not None:
            out = _mla_flash_decode(p["wkv_b"], q, ckv, k_rope, cache, idx,
                                    cfg, scale, mesh)
        elif mesh is not None:
            start = idx.to(torch.long).clamp(0, cache["ckv"].shape[1] - t)
            _write_local(cache["ckv"], ckv, start)
            _write_local(cache["krope"], k_rope, start)
            ckv = colshard.full_leaf(cache["ckv"])
            k_rope = colshard.full_leaf(cache["krope"])
        else:
            rows, cols = _write_at(idx, t, cache["ckv"])
            cache["ckv"][rows, cols] = ckv.to(cache["ckv"].dtype)
            cache["krope"][rows, cols] = k_rope.to(cache["krope"].dtype)
            ckv, k_rope = cache["ckv"], cache["krope"]

    if out is None:
        tk = ckv.shape[1]
        kv = apply_linear(p["wkv_b"], ckv, cfg.cim, compute_dtype=c).reshape(
            b, tk, h, m.qk_nope_dim + m.v_head_dim)
        k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
        k = torch.cat([k_nope, k_rope.expand(b, tk, h, m.qk_rope_dim)],
                      dim=-1)
        out = attention(q, k, v, causal=True, q_offset=q_offset,
                        kv_len=kv_len, chunk=cfg.attn_chunk, scale=scale)
    y = apply_linear(p["wo"], out.reshape(b, t, h * m.v_head_dim), cfg.cim,
                     compute_dtype=c)
    return y, new_cache


def _mla_flash_decode(wkv_b: Dict, q: torch.Tensor, ckv: torch.Tensor,
                      k_rope: torch.Tensor, cache: Dict, idx: torch.Tensor,
                      cfg: ModelConfig, scale: torch.Tensor,
                      mesh) -> torch.Tensor:
    """One decode token's MLA attention over a latent cache time-sharded
    over ``"model"`` (sequence-parallel MLA decode). The rank writes the
    new latent row where it owns the position, runs its time block (B,
    T/D, r) through every column of ``wkv_b`` (its column shards gathered
    at use, ``colshard.whole``, and the linear run as one device runs it:
    no session mesh, so no column-parallel gather joins other ranks' time
    blocks; its ADC records are parts over ``"model"``), attends over its
    keys with the rotary key broadcast over the heads, and the partial
    softmaxes merge over ``"model"`` (``_merge_over_model``). q (B, 1, H,
    qk) -> (B, 1, H, v_head_dim)."""
    from repro_torch.nn.module import session_mesh
    from repro_torch.obs import adc as obs_adc
    m = cfg.mla
    for name, rows in (("ckv", ckv), ("krope", k_rope)):
        _write_local(cache[name], rows, idx.to(torch.long))
    ckv_l, kr_l = cache["ckv"].to_local(), cache["krope"].to_local()
    b, t_loc = ckv_l.shape[:2]
    h = q.shape[2]
    w = {k: colshard.whole(v) for k, v in wkv_b.items()}
    with session_mesh(None), obs_adc.partial_over(("model",)):
        kv = apply_linear(w, ckv_l, cfg.cim, compute_dtype=cdt(cfg))
    kv = kv.reshape(b, t_loc, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    k = torch.cat([k_nope, kr_l.expand(b, t_loc, h, m.qk_rope_dim)], dim=-1)
    s = _scores(q, k, scale)                              # (B, H, 1, Tl)
    return _merge_over_model(_mask_local(s, idx, mesh), v, mesh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = pdt(cfg)
    if cfg.act == "swiglu":
        return {
            "wg": linear_specs(d, f, cim=cfg.cim, in_axis="embed",
                               out_axis="mlp", dtype=dt),
            "wu": linear_specs(d, f, cim=cfg.cim, in_axis="embed",
                               out_axis="mlp", dtype=dt),
            "wd": linear_specs(f, d, cim=cfg.cim, in_axis="mlp",
                               out_axis="embed", dtype=dt),
        }
    return {
        "wu": linear_specs(d, f, cim=cfg.cim, in_axis="embed", out_axis="mlp",
                           dtype=dt),
        "wd": linear_specs(f, d, cim=cfg.cim, in_axis="mlp", out_axis="embed",
                           dtype=dt),
    }


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU (or GELU) MLP; the activation runs in the compute dtype."""
    c = cdt(cfg)
    if cfg.act == "swiglu":
        g = apply_linear(p["wg"], x, cfg.cim, compute_dtype=c)
        u = apply_linear(p["wu"], x, cfg.cim, compute_dtype=c)
        return apply_linear(p["wd"], F.silu(g) * u, cfg.cim, compute_dtype=c)
    u = apply_linear(p["wu"], x, cfg.cim, compute_dtype=c)
    return apply_linear(p["wd"], F.gelu(u, approximate="tanh"), cfg.cim,
                        compute_dtype=c)


# ---------------------------------------------------------------------------
# Mixture-of-Experts with capacity-bounded dispatch
# ---------------------------------------------------------------------------

def moe_specs(cfg: ModelConfig) -> Dict:
    mo = cfg.moe
    d, f, e = cfg.d_model, mo.d_ff, mo.n_experts
    dt = pdt(cfg)
    sp = {
        "router": linear_specs(d, e, in_axis="embed", out_axis=None,
                               dtype=torch.float32),
        "wg": ParamSpec((e, d, f), dt, "fan_in:1.0", ("experts", "embed", "mlp")),
        "wu": ParamSpec((e, d, f), dt, "fan_in:1.0", ("experts", "embed", "mlp")),
        "wd": ParamSpec((e, f, d), dt, "fan_in:1.0", ("experts", "mlp", "embed")),
    }
    if cfg.cim.enabled:
        t = cfg.cim.tiling(d, f)
        t2 = cfg.cim.tiling(f, d)
        for nm, tt, oax in (("wg", t, "mlp"), ("wu", t, "mlp"),
                            ("wd", t2, "embed")):
            wg_s = tt.weight_scale_shape(cfg.cim.weight_granularity)
            pg_s = tt.psum_scale_shape(cfg.cim.psum_granularity)
            sp[f"{nm}_s_w"] = ParamSpec(
                (e,) + wg_s, torch.float32, "const:0.05",
                ("experts", None, oax if wg_s[1] == tt.n else None))
            sp[f"{nm}_s_p"] = ParamSpec(
                (e,) + pg_s, torch.float32, "const:8.0",
                ("experts", None, None, oax if pg_s[2] == tt.n else None))
            sp[f"{nm}_s_a"] = ParamSpec((e, 1), torch.float32, "ones",
                                        ("experts", None))
    if mo.n_shared:
        sp["shared"] = mlp_specs(cfg, d_ff=mo.d_ff * mo.n_shared)
    return sp


# ---------------------------------------------------------------------------
# decode caches over the mesh, and sequence-parallel flash decode
# ---------------------------------------------------------------------------

def _mesh_dims(mesh) -> Tuple[str, ...]:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def model_split(size: int):
    """The session mesh when its ``"model"`` ranks (more than one) divide a
    decode-cache dim of ``size``, else None: the reference's
    ``cache_shardings`` places the time of the K/V and latent caches and
    the heads of the SSD state over ``"model"`` wherever they divide, with
    or without flash decode."""
    from repro_torch.nn.module import current_mesh
    mesh = current_mesh()
    n = colshard.mesh_shards(mesh, "model")
    return mesh if n > 1 and size % n == 0 else None


def placed_over_model(leaf: torch.Tensor, dim: int):
    """The session mesh when a decode-cache leaf holds its ``dim`` over
    ``"model"`` as ``model_split`` places it under that mesh (its local
    block is this rank's), None when both say whole. Raises when they
    disagree: a cache made under another mesh, or none, is refused, never
    gathered or run whole where the mesh splits it."""
    mesh = model_split(leaf.shape[dim])
    split = colshard.model_dim(leaf)
    if mesh is None and split is None:
        return None
    if (mesh is None or split != dim % leaf.ndim
            or leaf.device_mesh != mesh):
        where = ("whole" if split is None else
                 f"placed over {colshard.sharded_dims(leaf)}")
        raise ValueError(
            f"a {tuple(leaf.shape)} decode-cache leaf is {where}; under this "
            f"session mesh init_cache places its dim {dim % leaf.ndim} "
            f"{'over model' if mesh is not None else 'whole'}: make the "
            "cache with init_cache under the mesh that steps it")
    return mesh


def _flash_decode_ep_ready(cfg: ModelConfig, t: int, t_cache: int,
                           b: int = 0):
    """The mesh when flash decode applies (the reference's predicate): one
    new token, ``cfg.flash_decode``, a session mesh whose ``"model"`` ranks
    split the cache's ``t_cache`` positions (``model_split``), and the
    global rows (``b``, a rank's rows inside a data parallel step, times
    the step's batch ranks) dividing over its batch axes. Else None."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.nn.module import batch_ranks
    mesh = model_split(t_cache)
    if t != 1 or not cfg.flash_decode or mesh is None:
        return None
    if b and (b * batch_ranks()) % colshard.batch_shard(
            mesh, batch_axes(mesh))[0]:
        return None
    return mesh


def rows_axes(batch: int) -> Tuple[str, ...]:
    """The session mesh's batch axes of more than one rank when their ranks
    divide ``batch`` rows (the reference's ``cache_shardings`` and
    ``bspec``: ``launch.cells._dim_axis_ok``), else (): the rows a data
    parallel serve step splits, and the rows of every cache leaf."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.nn.module import current_mesh
    mesh = current_mesh()
    axes = tuple(a for a in batch_axes(mesh)
                 if colshard.mesh_shards(mesh, a) > 1)
    n = colshard.batch_shard(mesh, axes)[0] if axes else 1
    return axes if axes and batch % n == 0 and batch >= n else ()


def cache_leaf(shape, dtype, dev: torch.device, *, row_dim: int = 1,
               model_dim: Optional[int] = None,
               fill: float = 0.0) -> torch.Tensor:
    """A decode-cache leaf of ``shape`` filled with ``fill``. Under a
    session mesh whose batch axes divide its rows (``rows_axes``) and,
    with ``model_dim`` (a cache's time, the SSD state's heads), whose
    ``"model"`` ranks divide that dim (``model_split``), this rank
    allocates only its block, a placed leaf carrying the global shape
    (the reference's ``cache_shardings``); else the whole tensor."""
    from repro_torch.nn.module import current_mesh
    mesh = current_mesh()
    dims = {}
    rows = rows_axes(shape[row_dim])
    if rows:
        dims[row_dim] = rows
    if model_dim is not None and model_split(shape[model_dim]) is not None:
        dims[model_dim] = ("model",)
    if not dims:
        return torch.full(tuple(shape), fill, dtype=dtype, device=dev)
    block = list(shape)
    for d, axes in dims.items():
        block[d] //= colshard.batch_shard(mesh, axes)[0]
    return colshard.placed(
        torch.full(tuple(block), fill, dtype=dtype, device=dev), mesh,
        colshard.placements_of(mesh, dims), tuple(shape))


def check_rows(cache) -> None:
    """Raise when a cache leaf holds its rows over the batch axes: such a
    cache is stepped by ``launch.cells.serve_rows`` (the serve cell's
    step), each rank on its rows, and not by a model's ``decode_step``
    on the whole batch."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.nn.module import current_mesh
    axes = batch_axes(current_mesh())
    if axes and any(colshard.holds_rows(x, axes) for x in tree_leaves(cache)):
        raise ValueError("this decode cache holds its rows over the batch "
                         f"axes {axes}: step it with launch.cells.serve_rows "
                         "(a serve cell's step_fn), each rank on its rows")


def kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
             dev: torch.device, int8: bool) -> Dict:
    """A stacked GQA decode cache (n_layers, batch, max_len, KvH, hd): K/V
    in the compute dtype, or int8 codes with float32 per-(token, head)
    scales, and the lengths (n_layers, batch). Under a session mesh
    (``cache_leaf``) every leaf holds its rows over the batch axes where
    their ranks divide the batch, and K/V and their scales hold their time
    over ``"model"`` where its ranks divide ``max_len``: each rank
    allocates only its block."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dtypes = ({"k": torch.int8, "v": torch.int8, "k_scale": torch.float32,
               "v_scale": torch.float32} if int8
              else {"k": cdt(cfg), "v": cdt(cfg)})
    out = {name: cache_leaf(shape if name in ("k", "v") else shape[:-1], dt,
                            dev, model_dim=2)
           for name, dt in dtypes.items()}
    out["len"] = cache_leaf((n_layers, batch), torch.int32, dev)
    return out


def _write_local(leaf, rows: torch.Tensor, start: torch.Tensor) -> None:
    """Write the T new rows (B, T, ...) of every batch row at positions
    ``start + 0..T-1`` into this rank's time block of a time-sharded
    cache leaf (its rows are the rank's own: the batch the step runs on):
    the positions in its time slice; the rest of the block keeps its
    values. Computed on the device over the whole block, so no index
    leaves it."""
    mesh = leaf.device_mesh
    block = leaf.to_local()                               # (B, Tl, ...)
    b, t_loc = block.shape[:2]
    t0 = colshard.mesh_coord(mesh, "model") * t_loc
    t = rows.shape[1]
    off = (t0 + torch.arange(t_loc, device=block.device))[None, :] - start[
        :, None]                                           # (B, Tl)
    inside = (off >= 0) & (off < t)
    src = rows.to(block.dtype)[
        torch.arange(b, device=block.device)[:, None], off.clamp(0, t - 1)]
    inside = inside.reshape(inside.shape + (1,) * (block.ndim - 2))
    block.copy_(torch.where(inside, src, block))


def _flash_decode_ep(q: torch.Tensor, new: Dict, cache: Dict,
                     idx: torch.Tensor, mesh) -> torch.Tensor:
    """One decode token's attention over a time-sharded cache (the
    reference's ``_flash_decode_ep``): the rank writes the new row where
    it owns the position (the int8 cache's codes and scales quantized
    once, by every rank alike), attends over its time slice, and the
    partial softmaxes merge over ``"model"`` (``_merge_over_model``). The
    rows are the step's own: under a mesh with batch axes a data parallel
    serve step (``launch.cells.serve_rows``) hands each rank its rows and
    their cache rows, so no row crosses the batch axes. q (B, 1, H, hd)
    -> (B, 1, H, hd)."""
    for name, rows in new.items():
        _write_local(cache[name], rows, idx.to(torch.long))
    local = {n: cache[n].to_local() for n in new}
    k_at, v_at = _dequantized(local, q.dtype)             # (B, Tl, KvH, hd)
    kvh, hd = k_at.shape[2:]
    h = q.shape[2]
    kk, vv = _repeat_kv(k_at, h // kvh), _repeat_kv(v_at, h // kvh)
    sc = 1.0 / torch.sqrt(torch.full((), float(hd), dtype=torch.float32,
                                     device=q.device))
    s = _scores(q, kk, sc)                                # (B, H, 1, Tl)
    return _merge_over_model(_mask_local(s, idx, mesh), vv, mesh).to(q.dtype)


def _mask_local(s: torch.Tensor, idx: torch.Tensor, mesh) -> torch.Tensor:
    """Scores (B, H, 1, Tl) of this rank's time block with the positions
    past each row's new token (``idx``) set to ``NEG_INF``."""
    t_loc = s.shape[-1]
    kpos = (colshard.mesh_coord(mesh, "model") * t_loc
            + torch.arange(t_loc, device=s.device))
    valid = kpos[None, :] < (idx + 1)[:, None]
    return torch.where(valid[:, None, None, :], s, NEG_INF)


def _merge_over_model(s: torch.Tensor, v: torch.Tensor,
                      mesh) -> torch.Tensor:
    """The attention output of one decode token from the ranks' time
    blocks: this rank's masked float32 scores s (B, H, 1, Tl) and values
    v (B, Tl, H, hd) -> (B, 1, H, hd) float32, merged over ``"model"`` as
    the reference merges them: a local max, a max all-reduce, ``exp(s -
    m_g)``, then sum all-reduces of ``l`` and ``acc``. Each rank weights
    its values by ``exp(s - m_g) / l`` rounded to ``v``'s dtype, as the
    plain path's softmax weights are, before the product (the reference
    divides the summed ``acc`` by ``l``: the same in float32 up to
    rounding, but in bfloat16 the weights' rounding is the plain path's,
    so the decode keeps its tokens). GQA's flash decode and the
    sequence-parallel MLA decode both end here."""
    m_g = colshard.all_reduce(s.amax(dim=-1), mesh, ("model",), "max")
    p = torch.exp(s - m_g[..., None])
    l_g = colshard.all_reduce(p.sum(dim=-1), mesh, ("model",))
    w = (p / torch.clamp_min(l_g[..., None], 1e-30)).to(v.dtype)
    acc = torch.einsum("bhqk,bkhd->bhqd", w.to(torch.float32),
                       v.to(torch.float32))
    return colshard.all_reduce(acc, mesh, ("model",)).permute(0, 2, 1, 3)


def _batched_experts_ok(p: Dict, nm: str, cfg: ModelConfig) -> bool:
    """The single-launch path: a clean integer (int8 or nibble) deploy bank
    of one layer (E-leading, rank 5), on the kernel, with the ADC
    collector disarmed (armed, every expert runs as its own ``linear``,
    whose dispatch records the side-output, as the reference does) and no
    column-parallel session mesh (under one, every expert runs as its own
    ``linear`` through the sharded dispatch, as the reference does). Every
    bank size takes it; the reference's 4 MiB gate is a TPU VMEM
    budget."""
    from repro_torch.kernels import ops as kops
    from repro_torch.nn.module import current_mesh
    from repro_torch.obs import adc as obs_adc
    d = p[f"{nm}_digits"]
    return (cfg.cim.mode == "deploy" and cfg.cim.use_kernel and d.ndim == 5
            and d.dtype in (torch.int8, torch.uint8)
            and not obs_adc.enabled()
            and kops.col_shards(current_mesh()) == 1)


def _bank_scale(full, key: str, bank: torch.Tensor, t) -> torch.Tensor:
    """(E, ...) per-expert scale parameters ``key`` -> their full
    per-expert form through ``full`` (``_full_weight_scale`` or
    ``_full_psum_scale``)."""
    if tuple(full({key: bank[0]}, t).shape) == tuple(bank.shape[1:]):
        return bank                       # column granularity: already full
    return torch.stack([full({key: s}, t) for s in bank])


def _batched_expert_matmul(p: Dict, nm: str, x: torch.Tensor,
                           cfg: ModelConfig,
                           counts: torch.Tensor | None = None) -> torch.Tensor:
    """All experts' capacity buffers through ONE launch of the CIM experts
    kernel (``kernels.ops.cim_matmul_experts``). The per-expert prep is
    ``core.cim_linear._forward_deploy``'s, batched over the expert axis:
    activation codes, tiling, ``deq = 2^(c*s) * s_w`` and ``s_a`` applied
    after the shift-and-add, so the result equals the per-expert loop of
    ``linear`` bit for bit on the rows below ``counts`` (each expert's
    filled slots; the kernel skips the rest and gives them the value of a
    zero input row)."""
    from repro_torch.core.bitsplit import place_values
    from repro_torch.core.cim_linear import (_full_psum_scale,
                                             _full_weight_scale, _tile_inputs,
                                             deploy_act_codes)
    from repro_torch.kernels import ops as kops
    cim = cfg.cim
    digits = p[f"{nm}_digits"]
    t = cim.tiling(x.shape[-1], digits.shape[-1])
    s_a = p[f"{nm}_s_a"][:, None, :]                         # (E, 1, 1)
    a_t = _tile_inputs(deploy_act_codes(x, s_a, cim), t)
    s_p = _bank_scale(_full_psum_scale, "s_p", p[f"{nm}_s_p"], t)
    s_w = _bank_scale(_full_weight_scale, "s_w", p[f"{nm}_s_w"], t)
    places = place_values(cim.weight_bits, cim.cell_bits, device=s_w.device)
    deq = places[None, :, None, None] * s_w[:, None]
    y = kops.cim_matmul_experts(a_t, digits, s_p, deq,
                                psum_bits=cim.psum_bits,
                                psum_quant=cim.psum_quant,
                                use_kernel=cim.use_kernel,
                                occ=p.get(f"{nm}_occ"), counts=counts)
    y = y * torch.clamp_min(s_a, 1e-9)
    return y.to(cdt(cfg))


def _per_expert_matmul(p: Dict, nm: str, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """A packed bank one ``linear`` per expert: adc_free and binary banks,
    float (variation-baked) planes, and the plain version."""
    from repro_torch.api import linear
    outs = []

    def expert(leaf, e):            # a column-sharded bank keeps its shards
        return col_apply(lambda v: v[e], leaf)
    for e in range(x.shape[0]):
        node = {"w_digits": expert(p[f"{nm}_digits"], e),
                **{s: expert(p[f"{nm}_{s}"], e)
                   for s in ("s_w", "s_p", "s_a")}}
        if f"{nm}_occ" in p:
            node["w_occ"] = expert(p[f"{nm}_occ"], e)
        outs.append(linear(x[e], node, cfg.cim, compute_dtype=cdt(cfg)))
    return torch.stack(outs)


def _expert_matmul(p: Dict, nm: str, x: torch.Tensor, cfg: ModelConfig,
                   counts: torch.Tensor | None = None) -> torch.Tensor:
    """x (E, C, K) -> (E, C, N), CIM-quantized per expert when enabled.
    ``counts`` (E,) int32: each expert's filled capacity slots, which the
    batched kernel path computes alone (the rows past them are not read
    downstream); the other paths compute every row."""
    c = cdt(cfg)
    if not cfg.cim.enabled:
        return torch.einsum("eck,ekn->ecn", x, p[nm].to(c))
    from repro_torch.api import linear
    from repro_torch.api.backends import is_packed
    if is_packed(cfg.cim) and f"{nm}_digits" in p:
        if _batched_experts_ok(p, nm, cfg):
            return _batched_expert_matmul(p, nm, x, cfg, counts)
        return _per_expert_matmul(p, nm, x, cfg)
    # unpacked tree on a packed backend: emulate (the same quantization
    # arithmetic; only the storage layout differs). One unbind per operand:
    # its backward stacks the experts' gradients once, where a slice per
    # expert would put each into a zero tensor of the whole bank
    ecfg = (cfg.cim if not is_packed(cfg.cim)
            else cfg.cim.replace(mode="emulate"))
    keys = ("w", "s_w", "s_p", "s_a")
    banks = [torch.unbind(p[nm if k == "w" else f"{nm}_{k}"]) for k in keys]
    return torch.stack([
        linear(x_e, {k: (b[e].to(torch.float32) if k == "w" else b[e])
                     for k, b in zip(keys, banks)}, ecfg, compute_dtype=c)
        for e, x_e in enumerate(torch.unbind(x))])


def route(logits: torch.Tensor, cfg: ModelConfig):
    """Top-k routing and capacity-bounded slot assignment of the reference
    (``_apply_moe_jit``). logits (N, E) float32 -> (gates (N, k), sel
    (N, k), slot (N*k,), cap).

    Top-k is a stable descending sort, so ties go to the lower expert
    index as ``jax.lax.top_k`` breaks them. Each expert's buffer holds
    ``cap`` slots: dropless (cap = N*k) when N*k <= 256, else
    ``int(capacity_factor * N*k / E) + 1``. Pairs are placed in (token,
    rank) order; an overflowing pair gets slot ``E*cap``, which is
    dropped."""
    mo = cfg.moe
    n_tok, e = logits.shape
    k = mo.top_k
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, sel = vals[:, :k], idx[:, :k]
    gates = (torch.softmax(gates, dim=-1) if mo.router_scale
             else torch.sigmoid(gates))
    cap = int(mo.capacity_factor * n_tok * k / e) + 1
    if n_tok * k <= 256:
        cap = n_tok * k
    flat_e = sel.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    start = torch.searchsorted(e_sorted, torch.arange(e, device=e_sorted.device),
                               side="left")
    pos_in_e = torch.arange(n_tok * k, device=e_sorted.device) - start[e_sorted]
    slot_sorted = torch.where(pos_in_e < cap, e_sorted * cap + pos_in_e,
                              e * cap)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    return gates, sel, slot, cap


def expert_counts(slot: torch.Tensor, n_experts: int,
                  cap: int) -> torch.Tensor:
    """(E,) int32 filled capacity slots per expert, from ``route``'s slots.
    Expert j's pairs fill slots j*cap + 0, 1, ...: a prefix of its buffer
    of min(pairs routed to j, cap) rows (dropped pairs, slot E*cap, count
    for no expert). Counted on the device with ``index_add_`` (CUDA's
    ``bincount`` reads the largest index back to the host), so a decode
    step can be captured in a CUDA graph."""
    counts = torch.zeros(n_experts + 1, dtype=torch.int32,
                         device=slot.device)
    return counts.index_add_(0, slot // cap, torch.ones_like(
        slot, dtype=torch.int32))[:n_experts]


def apply_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The MoE block, dispatched by the reference's predicate: raw banks
    (no ``*_digits``) with ``moe_impl != "jit"`` under a session mesh with
    ``"model"`` whose ranks divide the experts take the expert-parallel
    path (``_apply_moe_ep``); everything else the jit path
    (``_apply_moe_jit``). Packed banks take the jit path under a mesh too:
    their parallelism is the column sharding inside the kernel
    dispatch."""
    from repro_torch.nn.module import current_mesh
    mesh = current_mesh()
    if (cfg.moe_impl != "jit" and not any(k.endswith("_digits") for k in p)
            and "model" in _mesh_dims(mesh)
            and cfg.moe.n_experts % colshard.mesh_shards(mesh, "model") == 0):
        return _apply_moe_ep(p, x, cfg, mesh)
    return _apply_moe_jit(p, x, cfg)


def _ep_experts(leaf: torch.Tensor, mesh, lo: int, n: int, batch):
    """This rank's ``n`` experts from ``lo`` of a raw bank leaf, entering
    the rank-local expert computation: a bank placed over ``"model"``
    gives its local block, whose gradient is summed over the batch axes
    (each batch block's tokens reach it); a whole bank is sliced, and its
    gradient summed over every mesh dim."""
    if colshard.is_col_sharded(leaf):
        if colshard.sharded_dims(leaf) != {0: ("model",)}:
            raise ValueError("an expert bank is placed on its experts over "
                             "'model' (nn.module.shard_params), got "
                             f"{leaf.placements}")
        return colshard.grad_psum(leaf.to_local(), mesh, batch)
    return colshard.grad_psum(leaf, mesh, batch + ("model",))[lo:lo + n]


def _apply_moe_ep(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  mesh) -> torch.Tensor:
    """The expert-parallel MoE (the reference's ``_apply_moe_ep``): the
    experts split over ``"model"``, the tokens over the batch axes. Every
    rank holds the block's input whole; it routes its batch block's
    tokens, gathers those its experts own into capacity buffers
    (``max(int(cf * n_loc * k / E) + 1, 4)`` slots, dropless when ``n_loc
    * k <= 256``), runs its experts (CIM linears under emulate, whatever
    the mode: raw banks are never packed), combines its partial output,
    and one sum over ``"model"`` merges the partials; the batch blocks
    are gathered back. The input and the router enter through
    ``grad_psum`` and the partials leave through ``psum``, so the
    gradients equal one device's, with no factor of the rank count."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.nn.module import batch_parallel
    from repro_torch.obs import adc as obs_adc
    mo = cfg.moe
    b, t, d = x.shape
    c = cdt(cfg)
    p = colshard.unshard_tree(p)
    ranks_rows = batch_axes(mesh) + ("model",)
    # inside a data parallel step x holds this rank's rows already: no
    # further split, and the replicated leaves' gradients are summed over
    # the batch axes by the trainer
    batch = () if batch_parallel() is not None else batch_axes(mesh)
    every = batch + ("model",)
    e_local = mo.n_experts // colshard.mesh_shards(mesh, "model")
    lo = colshard.mesh_coord(mesh, "model") * e_local
    nb, bi = colshard.batch_shard(mesh, batch)
    if (b * t) % nb:
        raise ValueError(f"{b * t} tokens do not divide over {nb} batch "
                         "ranks")
    n_loc, k = b * t // nb, mo.top_k
    xf = x.reshape(b * t, d)
    xl = colshard.grad_psum(xf, mesh, every)[bi * n_loc:(bi + 1) * n_loc]
    router = colshard.grad_psum(p["router"]["w"], mesh, every)
    banks = {kk: _ep_experts(p[kk], mesh, lo, e_local, batch) for kk in p
             if kk in ("wg", "wu", "wd")
             or (cfg.cim.enabled and kk.startswith(("wg_", "wu_", "wd_")))}

    logits = xl.to(torch.float32) @ router.to(torch.float32)  # (n_loc, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates, sel = vals[:, :k], idx[:, :k]
    gates = (torch.softmax(gates, dim=-1) if mo.router_scale
             else torch.sigmoid(gates))
    cap = max(int(mo.capacity_factor * n_loc * k / mo.n_experts) + 1, 4)
    if n_loc * k <= 256:
        cap = n_loc * k

    flat_e = sel.reshape(-1)
    flat_tok = torch.arange(n_loc, device=x.device).repeat_interleave(k)
    mine = (flat_e >= lo) & (flat_e < lo + e_local)
    le = torch.where(mine, flat_e - lo, e_local)           # local expert id
    order = torch.argsort(le, stable=True)
    le_sorted = le[order]
    start = torch.searchsorted(le_sorted,
                               torch.arange(e_local, device=x.device),
                               side="left")
    pos = (torch.arange(n_loc * k, device=x.device)
           - start[le_sorted.clamp(0, e_local - 1)])
    slot_sorted = torch.where((le_sorted < e_local) & (pos < cap),
                              le_sorted * cap + pos, e_local * cap)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted

    buf = torch.zeros((e_local * cap + 1, d), dtype=c, device=x.device)
    buf[slot] = xl.to(c)[flat_tok]
    buf = buf[:-1].reshape(e_local, cap, d)
    with obs_adc.partial_over(ranks_rows):
        if cfg.act == "swiglu":
            h = F.silu(_expert_matmul(banks, "wg", buf, cfg).to(
                torch.float32)).to(c) * _expert_matmul(banks, "wu", buf, cfg)
        else:
            h = F.gelu(_expert_matmul(banks, "wu", buf, cfg).to(
                torch.float32), approximate="tanh").to(c)
        out_buf = _expert_matmul(banks, "wd", h, cfg).reshape(
            e_local * cap, d)
    out_buf = torch.cat([out_buf, torch.zeros((1, d), dtype=out_buf.dtype,
                                              device=x.device)])
    contrib = (out_buf[slot].to(torch.float32)
               * gates.reshape(-1)[:, None]).reshape(n_loc, k, d)
    y = torch.zeros((n_loc, d), dtype=torch.float32, device=x.device)
    for j in range(k):                 # rank order from 0.0, as the jit path
        y = y + contrib[:, j]
    y = colshard.psum(y, mesh, ("model",)).to(c)
    if nb > 1:
        y = colshard.gather(y, mesh, batch, 0)
    if mo.n_shared:
        y = y + apply_mlp(p["shared"], xf, cfg)
    return y.reshape(b, t, d)


def _apply_moe_jit(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if any(colshard.is_col_sharded(p[nm]) for nm in ("wg", "wu", "wd")
           if nm in p):
        raise ValueError("expert banks placed over the mesh run on the "
                         "expert-parallel path alone (moe_impl != 'jit' "
                         "under the mesh they were placed on)")
    mo = cfg.moe
    b, t, d = x.shape
    n_tok = b * t
    e, k = mo.n_experts, mo.top_k
    c = cdt(cfg)
    xf = x.reshape(n_tok, d)

    logits = apply_linear(p["router"], xf.to(torch.float32), None,
                          compute_dtype=torch.float32)        # (N, E)
    gates, _, slot, cap = route(logits, cfg)
    flat_tok = torch.arange(n_tok, device=x.device).repeat_interleave(k)

    # each pair's slot is written once; overflow lands on the dropped row
    counts = expert_counts(slot, e, cap)
    buf = torch.zeros((e * cap + 1, d), dtype=c, device=x.device)
    buf[slot] = xf.to(c)[flat_tok]
    buf = constrain(buf[:-1].reshape(e, cap, d), ("experts", None, None))

    if cfg.act == "swiglu":
        g = _expert_matmul(p, "wg", buf, cfg, counts)
        u = _expert_matmul(p, "wu", buf, cfg, counts)
        h = F.silu(g.to(torch.float32)).to(c) * u             # float32 SiLU
    else:
        h = F.gelu(_expert_matmul(p, "wu", buf, cfg, counts
                                  ).to(torch.float32),
                   approximate="tanh").to(c)
    # rows of out_buf past counts are not read: combine reads the filled
    # slots and the dropped row
    out_buf = _expert_matmul(p, "wd", h, cfg, counts).reshape(e * cap, d)
    out_buf = torch.cat([out_buf, torch.zeros((1, d), dtype=out_buf.dtype,
                                              device=x.device)])

    # combine: each token's k contributions summed in rank order from 0.0
    # (the order of the reference's sequential scatter-add; no atomics)
    contrib = (out_buf[slot].to(torch.float32) * gates.reshape(-1)[:, None]
               ).reshape(n_tok, k, d)
    y = torch.zeros((n_tok, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    y = constrain(y.to(c), ("batch", None))
    if mo.n_shared:
        y = y + apply_mlp(p["shared"], xf, cfg)
    return y.reshape(b, t, d)
