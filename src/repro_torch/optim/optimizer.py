"""Optimizers over the port's param trees (counterpart of
``repro.optim.optimizer``): AdamW, Adafactor (factored second moment:
O(n+m) state for an (n, m) weight) and SGD with momentum, each with a
state dtype (bfloat16 state halves its memory). Pure functions on nested
dicts and lists of tensors:

  state = <name>_init(params, state_dtype)
  params, state, grad_norm = <name>_step(params, grads, state, lr, ...)

Global-norm clipping and decoupled weight decay are applied inside the
step. Updates are computed in float32 and cast back to each leaf's dtype.

A leaf placed over a mesh (an expert bank, ``nn.module.shard_params``) is
updated on this rank's block alone and keeps its placement; its optimizer
state is the block's, a plain tensor on the rank. ``global_norm`` sums
each placed leaf's squares over the mesh dims splitting it and counts
every whole leaf once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.core import colshard


def _unzip(params, out, n: int):
    return tuple(tree_map(lambda _, o: o[i], params, out) for i in range(n))


def _device(tree) -> torch.device:
    return next(tree_leaves(tree)).device


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together: whole leaves' squares once, a
    placed leaf's block squares summed over the mesh dims splitting it (a
    collective when the tree holds one: every rank calls it)."""
    whole, parts = 0.0, {}
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(colshard.local(leaf).to(torch.float32)))
        if not colshard.is_col_sharded(leaf):
            whole = whole + sq
            continue
        axes = tuple(a for axs in colshard.sharded_dims(leaf).values()
                     for a in axs)
        mesh, part = parts.get(axes, (leaf.device_mesh, 0.0))
        parts[axes] = (mesh, part + sq)
    for axes, (mesh, part) in parts.items():
        whole = whole + colshard.all_reduce(part, mesh, axes)
    return torch.sqrt(whole)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before); ``max_norm <= 0`` clips nothing and reports 0."""
    if max_norm <= 0:
        return grads, torch.zeros((), device=_device(grads))
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return tree_map(lambda g: colshard.like(g, (colshard.local(g).to(
        torch.float32) * scale).to(g.dtype)), grads), gn


def _zeros(dtype):
    return lambda p: torch.zeros(colshard.local(p).shape, dtype=dtype,
                                 device=p.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, state_dtype=torch.float32):
    return {"m": tree_map(_zeros(state_dtype), params),
            "v": tree_map(_zeros(state_dtype), params),
            "step": _step0(params)}


def adamw_step(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.1, grad_clip=1.0):
    grads, gnorm = clip_by_global_norm(grads, grad_clip)
    t = state["step"] + 1
    bc1 = 1 - b1 ** t.to(torch.float32)
    bc2 = 1 - b2 ** t.to(torch.float32)

    def upd(p, g, m, v):
        gf = colshard.local(g).to(torch.float32)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        step_ = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        pf = colshard.local(p).to(torch.float32)
        pf = pf - lr * (step_ + weight_decay * pf)
        return (colshard.like(p, pf.to(p.dtype)), m_new.to(m.dtype),
                v_new.to(v.dtype))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = _unzip(params, out, 3)
    return new_params, {"m": new_m, "v": new_v, "step": t}, gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moments for >= 2-D params)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor_init(params, state_dtype=torch.float32):
    def init_leaf(p):
        shape = tuple(colshard.local(p).shape)
        if _factored(shape):
            return {"vr": torch.zeros(shape[:-1], dtype=state_dtype,
                                      device=p.device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:],
                                      dtype=state_dtype, device=p.device)}
        return {"v": torch.zeros(shape, dtype=state_dtype, device=p.device)}
    return {"v": tree_map(init_leaf, params), "step": _step0(params)}


def adafactor_step(params, grads, state, lr, *, decay=0.99, eps=1e-30,
                   weight_decay=0.0, grad_clip=1.0, clip_threshold=1.0):
    grads, gnorm = clip_by_global_norm(grads, grad_clip)

    def upd(p, g, v):
        gf = colshard.local(g).to(torch.float32)
        g2 = gf * gf + eps
        if _factored(gf.shape):
            vr = decay * v["vr"].to(torch.float32) + (1 - decay) * g2.mean(-1)
            vc = decay * v["vc"].to(torch.float32) + (1 - decay) * g2.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(-1, keepdim=True)[..., None],
                                       eps))
            u = gf / torch.sqrt(denom + eps)
            new_v = {"vr": vr.to(v["vr"].dtype), "vc": vc.to(v["vc"].dtype)}
        else:
            vv = decay * v["v"].to(torch.float32) + (1 - decay) * g2
            u = gf / torch.sqrt(vv + eps)
            new_v = {"v": vv.to(v["v"].dtype)}
        # update clipping (Adafactor's RMS rule)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
        u = u / torch.clamp_min(rms_u / clip_threshold, 1.0)
        pf = colshard.local(p).to(torch.float32)
        pf = pf - lr * u - lr * weight_decay * pf
        return colshard.like(p, pf.to(p.dtype)), new_v

    out = tree_map(upd, params, grads, state["v"])
    new_params, new_v = _unzip(params, out, 2)
    return new_params, {"v": new_v, "step": state["step"] + 1}, gnorm


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def sgdm_init(params, state_dtype=torch.float32):
    return {"mom": tree_map(_zeros(state_dtype), params),
            "step": _step0(params)}


def sgdm_step(params, grads, state, lr, *, momentum=0.9, weight_decay=0.0,
              grad_clip=1.0):
    grads, gnorm = clip_by_global_norm(grads, grad_clip)

    def upd(p, g, m):
        pf = colshard.local(p).to(torch.float32)
        gf = colshard.local(g).to(torch.float32) + weight_decay * pf
        m_new = momentum * m.to(torch.float32) + gf
        return (colshard.like(p, (pf - lr * m_new).to(p.dtype)),
                m_new.to(m.dtype))

    out = tree_map(upd, params, grads, state["mom"])
    new_params, new_m = _unzip(params, out, 2)
    return new_params, {"mom": new_m, "step": state["step"] + 1}, gnorm


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    step: Callable               # (params, grads, state, lr, **kw)


def make_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return Optimizer(adamw_init, adamw_step)
    if name == "adafactor":
        return Optimizer(adafactor_init, adafactor_step)
    if name == "sgdm":
        return Optimizer(sgdm_init, sgdm_step)
    raise ValueError(f"unknown optimizer {name!r}")
