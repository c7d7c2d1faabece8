"""Mamba2 (SSD) blocks of the port (counterpart of ``repro.models.mamba2``):
the chunked state-space-dual scan for train and prefill, and the O(1)-state
recurrent step for decode. Used inside the zamba2 hybrid.

The SSD state update is an activation-activation op (no stored weight), so
it is not CIM-mapped and runs as plain torch; the in/out projections are
CIM-quantized linears like every other stored-weight matmul. The scan over
chunks is a Python loop in the reference's ``lax.scan`` order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import colshard
from repro_torch.nn.linear import apply_linear, linear_specs
from repro_torch.nn.module import ParamSpec

from .layers import (apply_norm, cache_leaf, cdt, norm_specs, pdt,
                     placed_over_model)


def mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    n_groups = 1
    conv_dim = d_inner + 2 * n_groups * s.d_state
    return d_inner, n_heads, n_groups, conv_dim


def _uniform(lo: float, hi: float, fn):
    """A spec init drawing uniform [lo, hi) float32 and mapping it by
    ``fn``."""
    def init(g, s, d, dev):
        u = torch.rand(tuple(s), generator=g, dtype=torch.float32,
                       device=dev) * (hi - lo) + lo
        return fn(u).to(d)
    return init


def mamba2_specs(cfg: ModelConfig) -> Dict:
    s = cfg.ssm
    d_inner, nh, ng, conv_dim = mamba_dims(cfg)
    dt = pdt(cfg)
    in_dim = 2 * d_inner + 2 * ng * s.d_state + nh
    return {
        "ln": norm_specs(cfg),
        "in_proj": linear_specs(cfg.d_model, in_dim, cim=cfg.cim,
                                in_axis="embed", out_axis="mlp", dtype=dt),
        "conv_w": ParamSpec((s.d_conv, conv_dim), dt, "fan_in:1.0",
                            (None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), torch.float32, "zeros", ("mlp",)),
        "A_log": ParamSpec((nh,), torch.float32,
                           _uniform(1.0, 16.0, torch.log), (None,)),
        "D": ParamSpec((nh,), torch.float32, "ones", (None,)),
        "dt_bias": ParamSpec(
            (nh,), torch.float32,
            _uniform(1e-3, 0.1, lambda u: torch.log(torch.exp(u) - 1.0
                                                    + 1e-9)), (None,)),
        "out_norm": {"scale": ParamSpec((d_inner,), torch.float32, "ones",
                                        ("mlp",))},
        "out_proj": linear_specs(d_inner, cfg.d_model, cim=cfg.cim,
                                 in_axis="mlp", out_axis="embed", dtype=dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x (B, L, C), w (K, C). Returns (silu(y),
    new state): the state is the last K-1 inputs, for streaming decode."""
    k = w.shape[0]
    if state is not None:
        xin = torch.cat([state, x], dim=1)                    # (B, K-1+L, C)
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
    y = sum(xin[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k))
    y = y + b[None, None, :].to(y.dtype)
    new_state = xin[:, xin.shape[1] - (k - 1):, :]
    return F.silu(y), new_state


def _segsum_decay(da_cs: torch.Tensor) -> torch.Tensor:
    """da_cs (..., Q, H) within-chunk inclusive cumsum of dt*A -> the
    lower-triangular decay (..., H, Q, Q), L[i, j] = exp(cs_i - cs_j) for
    i >= j, else 0."""
    cs = da_cs.transpose(-1, -2)                              # (..., H, Q)
    diff = cs[..., :, None] - cs[..., None, :]
    q = cs.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=da_cs.device))
    return torch.where(mask, torch.exp(diff), 0.0)


def ssd_chunked(x, dt, A, B, C, D, chunk: int, initial_state=None):
    """Chunked SSD scan (Mamba2 alg. 1).

    x (b, L, H, P); dt (b, L, H); A (H,); B, C (b, L, G, N); D (H,);
    ``initial_state`` an optional (b, H, N, P) carried state (stateful
    prefill). Returns y (b, L, H, P) and the final state (b, H, N, P)
    float32."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(B, rep, dim=2)               # (b, L, H, N)
    Ch = torch.repeat_interleave(C, rep, dim=2)
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // chunk
    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)
    Bc = Bh.reshape(b, nc, chunk, H, N)
    Cc = Ch.reshape(b, nc, chunk, H, N)

    xdt = xc * dtc[..., None]                                 # fold dt into x
    da = dtc * A[None, None, None, :]                         # (b,nc,Q,H) <= 0
    da_cs = torch.cumsum(da, dim=2)

    # intra-chunk (diagonal blocks)
    Ldec = _segsum_decay(da_cs)                               # (b,nc,H,Q,Q)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * Ldec
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xdt)

    # chunk-final states
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)     # (b,nc,Q,H)
    states = torch.einsum("bclhn,bclhp->bchnp",
                          Bc * decay_states[..., None], xdt)

    # inter-chunk recurrence, each chunk given the state before it
    chunk_decay = torch.exp(da_cs[:, :, -1, :])               # (b,nc,H)
    S = (initial_state.to(torch.float32) if initial_state is not None
         else torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(S)
        S = S * chunk_decay[:, c][..., None, None] + states[:, c].to(
            torch.float32)
    prev_states = torch.stack(prev, dim=1)                    # (b,nc,H,N,P)

    state_decay_in = torch.exp(da_cs)                         # (b,nc,Q,H)
    y_off = torch.einsum("bclhn,bchnp->bclhp", Cc,
                         prev_states.to(Cc.dtype)) * state_decay_in[..., None]

    y = (y_diag + y_off).reshape(b, L + pad, H, P)[:, :L]
    y = y + x[:, :L] * D[None, None, :, None]
    return y, S


def apply_mamba2(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba2 block. ``state`` = {"conv": (B, K-1, conv_dim), "ssd":
    (B, H, N, P)} for streaming decode, None for train and prefill.
    Returns (x + block(x), the new state or None); the state passed in is
    not written.

    An ``ssd`` state placed with its heads over ``"model"``
    (``init_mamba_state`` or ``zamba2.init_cache`` under a session mesh,
    as the reference's ``cache_shardings`` places it) runs head-parallel:
    the in-projection's output is whole on every rank, the rank takes its
    heads of x, dt, A and D, runs the chunked scan or the one-token
    recurrence on them and on its state block (each head is independent),
    and ``y`` is gathered over ``"model"`` along the heads before the gated
    RMSNorm, which reads all of ``d_inner``. The new state comes back
    placed as the one passed in. The decay ``exp(dt A)`` of the one-token
    step is taken over every head first, so each rank's heads round as
    one device's."""
    s = cfg.ssm
    d_inner, nh, ng, conv_dim = mamba_dims(cfg)
    bsz, L, _ = x.shape

    h = apply_norm(p["ln"], x, cfg)
    zxbcdt = apply_linear(p["in_proj"], h, cfg.cim, compute_dtype=cdt(cfg))
    z, xbc, dt_pre = torch.split(
        zxbcdt, [d_inner, conv_dim, zxbcdt.shape[-1] - d_inner - conv_dim],
        dim=-1)

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(
        xbc.to(torch.float32), p["conv_w"].to(torch.float32), p["conv_b"],
        conv_state)
    xs, B, C = torch.split(xbc, [d_inner, ng * s.d_state, ng * s.d_state],
                           dim=-1)

    # jax.nn.softplus: log(1 + e^x) with no threshold
    pre = dt_pre.to(torch.float32) + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros((), device=pre.device))
    A = -torch.exp(p["A_log"])                                # (H,) < 0
    D = p["D"]
    xh = xs.reshape(bsz, L, nh, s.head_dim)
    Bm = B.reshape(bsz, L, ng, s.d_state)
    Cm = C.reshape(bsz, L, ng, s.d_state)
    dec = torch.exp(dt[:, 0] * A[None, :]) if L == 1 else None  # (B, H)

    mesh = None if state is None else placed_over_model(state["ssd"], 1)
    S0 = None if state is None else colshard.local(state["ssd"])
    if mesh is not None:
        n_loc = S0.shape[1]
        heads = slice(colshard.mesh_coord(mesh, "model") * n_loc,
                      (colshard.mesh_coord(mesh, "model") + 1) * n_loc)
        xh, dt, A, D = xh[:, :, heads], dt[:, :, heads], A[heads], D[heads]
        dec = None if dec is None else dec[:, heads]

    if state is None:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, D, s.chunk)
        S = None
    elif L > 1:
        # stateful prefill: the chunked scan from the carried state
        y, S = ssd_chunked(xh, dt, A, Bm, Cm, D, s.chunk, initial_state=S0)
    else:
        # the single-step recurrence (L == 1)
        dt1 = dt[:, 0]                                        # (B,H)
        Bx = torch.einsum("bn,bhp->bhnp", Bm[:, 0, 0],
                          xh[:, 0] * dt1[..., None])
        S = S0 * dec[..., None, None] + Bx
        y = (torch.einsum("bn,bhnp->bhp", Cm[:, 0, 0], S)
             + xh[:, 0] * D[None, :, None])
        y = y[:, None]                                        # (B,1,H,P)
    if mesh is not None:
        y = colshard.gather(y.contiguous(), mesh, ("model",), 2)
    new_state = (None if state is None else
                 {"conv": new_conv, "ssd": colshard.like(state["ssd"], S)})

    y = y.reshape(bsz, L, d_inner)
    # gated RMSNorm (mamba2's norm before the out projection)
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    yf = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    yf = yf * p["out_norm"]["scale"]
    out = apply_linear(p["out_proj"], yf.to(cdt(cfg)), cfg.cim,
                       compute_dtype=cdt(cfg))
    return x + out, new_state


def state_leaves(cfg: ModelConfig, batch: int) -> Dict:
    """{name: (shape, dim over "model" or None)} of one Mamba2 block's
    decode state: the conv window (rows only), and the SSD state, whose
    heads the reference's ``cache_shardings`` places over ``"model"``."""
    s = cfg.ssm
    d_inner, nh, ng, conv_dim = mamba_dims(cfg)
    return {"conv": ((batch, s.d_conv - 1, conv_dim), None),
            "ssd": ((batch, nh, s.d_state, s.head_dim), 1)}


def init_mamba_state(cfg: ModelConfig, batch: int, *, device=None) -> Dict:
    """Zero float32 decode state of one Mamba2 block on ``device``
    (``cuda`` unless ``"cpu"``); under a session mesh every leaf holds its
    rows over the batch axes where their ranks divide ``batch``, and the
    SSD state its heads over ``"model"`` where its ranks divide them
    (``layers.cache_leaf``)."""
    dev = resolve_device(device)
    return {k: cache_leaf(shape, torch.float32, dev, row_dim=0,
                          model_dim=dim)
            for k, (shape, dim) in state_leaves(cfg, batch).items()}
