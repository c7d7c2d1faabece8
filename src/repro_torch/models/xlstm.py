"""xLSTM LM of the port (counterpart of ``repro.models.xlstm``,
arXiv:2405.04517): mLSTM blocks (matrix memory, chunkwise parallel like
linear attention) at a 7:1 ratio with sLSTM blocks (scalar memory,
strictly recurrent, exponential gating). Both carry O(1) state per layer.

Stabilization follows the paper: log-sigmoid forget gates, exponential
input gates, a running max-state m so every exponential is at most 1. The
recurrences are activation-activation ops outside any kernel and run as
plain torch, the chunk scan and the sLSTM token loop as Python loops in
the reference's ``lax.scan`` order; the stored-weight projections are CIM
linears (``w_if`` a float32 non-CIM one, as in the reference). A one-token
decode step pads to a whole chunk, as the reference does. Decode writes
each layer's ``conv``, ``cell`` (C, n, m) and sLSTM h/c/n/m in place
(``copy_``), so a step can be captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.core import colshard
from repro_torch.nn.linear import apply_linear, linear_specs
from repro_torch.nn.module import ParamSpec, stack_specs

from .layers import apply_norm, cache_leaf, cdt, check_rows, norm_specs, pdt
from .transformer import _layer, _layers, embed_lookup

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig):
    d_inner = 2 * cfg.d_model
    nh = cfg.n_heads
    hd = d_inner // nh
    return d_inner, nh, hd


def mlstm_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    d_inner, nh, hd = _mlstm_dims(cfg)
    dt = pdt(cfg)
    return {
        "ln": norm_specs(cfg),
        "up": linear_specs(d, 2 * d_inner, cim=cfg.cim, in_axis="embed",
                           out_axis="mlp", dtype=dt),
        "conv_w": ParamSpec((4, d_inner), dt, "fan_in:1.0", (None, "mlp")),
        "conv_b": ParamSpec((d_inner,), torch.float32, "zeros", ("mlp",)),
        "wq": linear_specs(d_inner, d_inner, cim=cfg.cim, in_axis="mlp",
                           out_axis="heads", dtype=dt),
        "wk": linear_specs(d_inner, d_inner, cim=cfg.cim, in_axis="mlp",
                           out_axis="heads", dtype=dt),
        "wv": linear_specs(d_inner, d_inner, cim=cfg.cim, in_axis="mlp",
                           out_axis="heads", dtype=dt),
        "w_if": linear_specs(d_inner, 2 * nh, in_axis="mlp", out_axis=None,
                             dtype=torch.float32),
        "out_norm": {"scale": ParamSpec((d_inner,), torch.float32, "ones",
                                        ("mlp",))},
        "down": linear_specs(d_inner, d, cim=cfg.cim, in_axis="mlp",
                             out_axis="embed", dtype=dt),
    }


def _causal_conv1d(x, w, b, state=None):
    k = w.shape[0]
    xin = (torch.cat([state, x], dim=1) if state is not None
           else F.pad(x, (0, 0, k - 1, 0)))
    y = sum(xin[:, i:i + x.shape[1], :] * w[i][None, None]
            for i in range(k))
    new_state = xin[:, xin.shape[1] - (k - 1):, :]
    return F.silu(y + b[None, None]), new_state


def _mlstm_chunked(q, k, v, li, lf, chunk: int, carry=None):
    """Stabilized chunkwise mLSTM.

    q, k, v (B, L, H, hd); li, lf (B, L, H) log input / log forget gates;
    ``carry`` an optional (C, n, m) state. Returns y (B, L, H, hd) float32
    and the final carry."""
    b, L, H, hd = q.shape
    # the scale in float32, as the reference's jnp.sqrt of a Python float
    q = q.to(torch.float32) / torch.sqrt(torch.full(
        (), float(hd), dtype=torch.float32, device=q.device))
    k = k.to(torch.float32)
    v = v.to(torch.float32)
    pad = (-L) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        li = F.pad(li, (0, 0, 0, pad), value=NEG)
        lf = F.pad(lf, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    qc = q.reshape(b, nc, chunk, H, hd)
    kc = k.reshape(b, nc, chunk, H, hd)
    vc = v.reshape(b, nc, chunk, H, hd)
    lic = li.reshape(b, nc, chunk, H)
    lfc = lf.reshape(b, nc, chunk, H)

    if carry is None:
        C = torch.zeros((b, H, hd, hd), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, H, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, H), NEG, dtype=torch.float32, device=q.device)
    else:
        C, n, m = carry
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    ys = []
    for c in range(nc):
        qb, kb, vb, lib, lfb = (qc[:, c], kc[:, c], vc[:, c], lic[:, c],
                                lfc[:, c])                    # (B, Q, H, ...)
        Fc = torch.cumsum(lfb, dim=1)                # (B,Q,H) inclusive
        p = lib - Fc                                 # source potentials
        M = torch.maximum(torch.cummax(p, dim=1).values, m[:, None, :])
        # intra-chunk: S[i, j] = (q_i . k_j) * exp(p_j - M_i), j <= i
        dots = torch.einsum("bihd,bjhd->bhij", qb, kb)
        w_arg = (p.transpose(1, 2)[:, :, None, :]                 # p_j
                 - M.transpose(1, 2)[:, :, :, None])              # M_i
        w_ij = torch.exp(torch.where(mask[None, None], w_arg, -torch.inf))
        S = dots * w_ij
        y = torch.einsum("bhij,bjhd->bihd", S, vb)
        # the carried state's contribution: weight exp(m - M_i)
        w_st = torch.exp(m[:, None, :] - M)                       # (B,Q,H)
        y = y + torch.einsum("bihd,bhde->bihe", qb, C) * w_st[..., None]
        # normalizer: q.n_i = row sums of S plus the carried-state part
        qn = (torch.sum(S, dim=-1).transpose(1, 2)
              + torch.einsum("bihd,bhd->bih", qb, n) * w_st)
        m_i = Fc + M
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_i))
        ys.append(y / denom[..., None])
        # chunk-final state update
        F_last = Fc[:, -1, :]                                     # (B,H)
        m_new = F_last + torch.maximum(m, torch.amax(p, dim=1))
        w_c = torch.exp(m + F_last - m_new)                       # carry decay
        w_j = torch.exp(F_last[:, None] + p - m_new[:, None])     # (B,Q,H)
        C = C * w_c[..., None, None] + torch.einsum(
            "bjhd,bjhe->bhde", kb * w_j[..., None], vb)
        n = n * w_c[..., None] + torch.einsum("bjhd,bjh->bhd", kb, w_j)
        m = m_new
    y = torch.stack(ys, dim=1).reshape(b, L + pad, H, hd)[:, :L]
    return y, (C, n, m)


def apply_mlstm(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One mLSTM block; ``state`` = {"conv", "cell": (C, n, m)} for decode.
    Returns (x + block(x), the new state or None)."""
    d_inner, nh, hd = _mlstm_dims(cfg)
    b, L, _ = x.shape
    c = cdt(cfg)
    h = apply_norm(p["ln"], x, cfg)
    up = apply_linear(p["up"], h, cfg.cim, compute_dtype=c)
    u, z = torch.chunk(up, 2, dim=-1)

    conv_state = state["conv"] if state is not None else None
    uc, new_conv = _causal_conv1d(u.to(torch.float32),
                                  p["conv_w"].to(torch.float32),
                                  p["conv_b"], conv_state)
    uc = uc.to(c)
    q = apply_linear(p["wq"], uc, cfg.cim, compute_dtype=c
                     ).reshape(b, L, nh, hd)
    k = apply_linear(p["wk"], uc, cfg.cim, compute_dtype=c
                     ).reshape(b, L, nh, hd)
    v = apply_linear(p["wv"], u, cfg.cim, compute_dtype=c
                     ).reshape(b, L, nh, hd)
    gates = apply_linear(p["w_if"], u.to(torch.float32), None,
                         compute_dtype=torch.float32)
    li, lf_pre = torch.chunk(gates, 2, dim=-1)                # (B,L,nh)
    lf = F.logsigmoid(lf_pre)

    carry = tuple(state["cell"]) if state is not None else None
    y, new_cell = _mlstm_chunked(q, k, v, li, lf, cfg.ssm.chunk, carry)
    y = y.reshape(b, L, d_inner).to(torch.float32)
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-6)
    y = y * p["out_norm"]["scale"]
    y = y * F.silu(z.to(torch.float32))
    out = apply_linear(p["down"], y.to(c), cfg.cim, compute_dtype=c)
    new_state = ({"conv": new_conv, "cell": new_cell}
                 if state is not None else None)
    return x + out, new_state


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    nh = cfg.ssm.n_slstm_heads
    hd = d // nh
    dt = pdt(cfg)
    f_ff = (4 * d) // 3
    return {
        "ln": norm_specs(cfg),
        "wx": linear_specs(d, 4 * d, cim=cfg.cim, in_axis="embed",
                           out_axis="mlp", dtype=dt),
        "r": ParamSpec((4, nh, hd, hd), torch.float32, "fan_in:1.0",
                       (None, None, None, None)),
        "bias": ParamSpec((4, d), torch.float32, "zeros", (None, "embed")),
        "ln_ffn": norm_specs(cfg),
        "ffn_up": linear_specs(d, 2 * f_ff, cim=cfg.cim, in_axis="embed",
                               out_axis="mlp", dtype=dt),
        "ffn_down": linear_specs(f_ff, d, cim=cfg.cim, in_axis="mlp",
                                 out_axis="embed", dtype=dt),
    }


def apply_slstm(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One sLSTM block and its gated FFN; ``state`` = {"h", "c", "n", "m"}
    for decode. Returns (the block's output, the new state or None)."""
    d = cfg.d_model
    nh = cfg.ssm.n_slstm_heads
    hd = d // nh
    b, L, _ = x.shape
    c = cdt(cfg)
    xin = apply_norm(p["ln"], x, cfg)
    wx = apply_linear(p["wx"], xin, cfg.cim, compute_dtype=c
                      ).to(torch.float32)
    wx = wx + p["bias"].reshape(1, 1, 4 * d)
    wz, wi, wf, wo = torch.chunk(wx, 4, dim=-1)               # (B,L,d)

    if state is None:
        h = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        cc = torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        n = torch.full((b, nh, hd), 1e-6, dtype=torch.float32,
                       device=x.device)
        m = torch.full((b, nh, hd), NEG, dtype=torch.float32,
                       device=x.device)
    else:
        h, cc, n, m = state["h"], state["c"], state["n"], state["m"]

    r = p["r"]
    hs = []
    for t in range(L):
        def rec(g, h=h):
            return torch.einsum("bhk,hkj->bhj", h, r[g])
        zt = torch.tanh(wz[:, t].reshape(b, nh, hd) + rec(0))
        it = wi[:, t].reshape(b, nh, hd) + rec(1)
        ft = F.logsigmoid(wf[:, t].reshape(b, nh, hd) + rec(2))
        ot = torch.sigmoid(wo[:, t].reshape(b, nh, hd) + rec(3))
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        cc = f_p * cc + i_p * zt
        n = f_p * n + i_p
        h = ot * cc / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, L, d)

    out = x + y.to(c)
    # gated FFN (GeGLU, 4/3 expansion); jax.nn.gelu is the tanh form
    z2 = apply_norm(p["ln_ffn"], out, cfg)
    up = apply_linear(p["ffn_up"], z2, cfg.cim, compute_dtype=c)
    g, u = torch.chunk(up, 2, dim=-1)
    ff = apply_linear(p["ffn_down"],
                      F.gelu(g.to(torch.float32), approximate="tanh").to(c)
                      * u, cfg.cim, compute_dtype=c)
    out = out + ff
    new_state = ({"h": h, "c": cc, "n": n, "m": m}
                 if state is not None else None)
    return out, new_state


# ---------------------------------------------------------------------------
# full LM
# ---------------------------------------------------------------------------

def _layer_kinds(cfg: ModelConfig):
    every = cfg.ssm.slstm_every
    return ["slstm" if every and (i % every == every - 1) else "mlstm"
            for i in range(cfg.n_layers)]


def specs(cfg: ModelConfig) -> Dict:
    kinds = _layer_kinds(cfg)
    n_m = kinds.count("mlstm")
    n_s = kinds.count("slstm")
    sp: Dict = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), pdt(cfg), "normal:0.02",
                           ("vocab", "embed")),
        "ln_f": norm_specs(cfg),
        "mlstm_layers": stack_specs(mlstm_specs(cfg), n_m),
        "lm_head": linear_specs(cfg.d_model, cfg.vocab, in_axis="embed",
                                out_axis="vocab", dtype=pdt(cfg),
                                init="normal:0.02"),
    }
    if n_s:
        sp["slstm_layers"] = stack_specs(slstm_specs(cfg), n_s)
    return sp


def _iterate(params, x, cfg, states):
    """mLSTM and sLSTM blocks in config order; with ``states`` each layer's
    state is written in place into its cache slice."""
    kinds = _layer_kinds(cfg)
    # each kind's layers through one unbind per leaf: the backward stacks
    # their gradients once (transformer._layers)
    stacks = {kind: _layers(params[f"{kind}_layers"], kinds.count(kind))
              for kind in dict.fromkeys(kinds)}
    seen = {"mlstm": 0, "slstm": 0}
    for kind in kinds:
        i = seen[kind]
        seen[kind] += 1
        st = None if states is None else _layer(states[kind], i)
        apply = apply_mlstm if kind == "mlstm" else apply_slstm
        x, ns = apply(colshard.at_use(stacks[kind][i]), x, cfg, state=st)
        if ns is not None:                # into the cache slice, in place
            tree_map(lambda dst, new: dst.copy_(new), st, ns)
    return x, states


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds=None) -> torch.Tensor:
    x = embed_lookup(params["embed"], tokens).to(cdt(cfg))
    x, _ = _iterate(params, x, cfg, None)
    x = apply_norm(params["ln_f"], x, cfg)
    return apply_linear(params["lm_head"], x, None, compute_dtype=cdt(cfg))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict:
    """Every layer's initial recurrent state, stacked per block kind, on
    ``device`` (``cuda`` unless ``"cpu"``); ``max_len`` is not needed (the
    state is O(1)). Under a session mesh every leaf holds its rows over
    the batch axes where their ranks divide ``batch``
    (``layers.cache_leaf``)."""
    dev = resolve_device(device)
    d_inner, nh, hd = _mlstm_dims(cfg)
    kinds = _layer_kinds(cfg)
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    nsh = cfg.ssm.n_slstm_heads
    shd = cfg.d_model // nsh

    def full(shape, v):
        return cache_leaf(shape, torch.float32, dev, fill=v)
    return {
        "mlstm": {
            "conv": full((n_m, batch, 3, d_inner), 0.0),
            "cell": (full((n_m, batch, nh, hd, hd), 0.0),
                     full((n_m, batch, nh, hd), 0.0),
                     full((n_m, batch, nh), NEG)),
        },
        "slstm": {
            "h": full((n_s, batch, nsh, shd), 0.0),
            "c": full((n_s, batch, nsh, shd), 0.0),
            "n": full((n_s, batch, nsh, shd), 1e-6),
            "m": full((n_s, batch, nsh, shd), NEG),
        },
    }


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step (or a stateful prefill of T tokens); the states are
    written in place and the same cache comes back."""
    check_rows(cache)
    x = embed_lookup(params["embed"], tokens).to(cdt(cfg))
    x, cache = _iterate(params, x, cfg, cache)
    x = apply_norm(params["ln_f"], x, cfg)
    return (apply_linear(params["lm_head"], x, None, compute_dtype=cdt(cfg)),
            cache)
