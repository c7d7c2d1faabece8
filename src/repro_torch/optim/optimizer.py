"""Optimizers over the port's param trees (counterpart of
``repro.optim.optimizer``): AdamW, Adafactor (factored second moment:
O(n+m) state for an (n, m) weight) and SGD with momentum, each with a
state dtype (bfloat16 state halves its memory). Pure functions on nested
dicts and lists of tensors:

  state = <name>_init(params, state_dtype)
  params, state, grad_norm = <name>_step(params, grads, state, lr, ...)

Global-norm clipping and decoupled weight decay are applied inside the
step. Updates are computed in float32 and cast back to each leaf's dtype.

A leaf placed over a mesh (``nn.module.shard_params``) is updated on this
rank's block alone and keeps its placement; its optimizer state is placed
as the reference's ``launch.cells._opt_shardings`` places it (the
param's placement; Adafactor's ``vr``/``vc`` with the reduced dim
dropped, their means taken over the whole dim). Under ZeRO-1 the state
is further split over the batch axes while the param is replicated
there: the rank updates its block of the param and the blocks are
all-gathered, once a step. ``global_norm`` sums each placed leaf's squares
over the mesh dims splitting it and counts every whole leaf once.
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
    """A zero state leaf placed as its parameter (its block, carrying the
    global shape: ``checkpoint.save`` writes it whole)."""
    return lambda p: colshard.like(p, torch.zeros(
        colshard.local(p).shape, dtype=dtype, device=p.device))


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(params))


def _zero1(p, s):
    """{dim: batch axes} that split the state leaf ``s`` and not its
    parameter ``p``: ZeRO-1's placement (``launch.cells._zero1_shardings``),
    where the rank updates its block and the param is gathered after."""
    if not colshard.is_col_sharded(s):
        return {}
    have = (colshard.sharded_dims(p) if colshard.is_col_sharded(p) else {})
    return {d: tuple(a for a in axes if a not in have.get(d, ()))
            for d, axes in colshard.sharded_dims(s).items()
            if any(a not in have.get(d, ()) for a in axes)}


def _block(x: torch.Tensor, mesh, extra: dict) -> torch.Tensor:
    for dim, axes in extra.items():
        n, i = colshard.batch_shard(mesh, axes)
        w = x.shape[dim] // n
        x = x.narrow(dim, i * w, w)
    return x


def _blockwise(upd):
    """``upd`` on local blocks, ZeRO-1 included: the rank updates its block
    of a param whose state the batch axes split further, and the new
    param's blocks are gathered over them."""
    def run(p, g, *states):
        ref = next((s for s in tree_leaves(list(states))
                    if colshard.is_col_sharded(s)), None)
        extra = _zero1(p, ref) if ref is not None else {}
        pl, gl = colshard.local(p), colshard.local(g)
        if extra:
            mesh = ref.device_mesh
            pl, gl = _block(pl, mesh, extra), _block(gl, mesh, extra)
        new_p, *new_s = upd(pl, gl, *states)
        if extra:
            for dim, axes in extra.items():
                new_p = colshard.all_gather(new_p, mesh, axes, dim)
        return (colshard.like(p, new_p), *new_s)
    return run


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

    @_blockwise
    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m_new = b1 * colshard.local(m).to(torch.float32) + (1 - b1) * gf
        v_new = b2 * colshard.local(v).to(torch.float32) + (1 - b2) * gf * gf
        step_ = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (step_ + weight_decay * pf)
        return (pf.to(p.dtype), colshard.like(m, m_new.to(m.dtype)),
                colshard.like(v, v_new.to(v.dtype)))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = _unzip(params, out, 3)
    return new_params, {"m": new_m, "v": new_v, "step": t}, gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moments for >= 2-D params)
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _dims(p) -> dict:
    return colshard.sharded_dims(p) if colshard.is_col_sharded(p) else {}


def _reduced_state(p, dtype, drop: int):
    """A factored state leaf (the param with dim ``drop`` reduced away),
    placed as the param's remaining dims are."""
    loc = list(colshard.local(p).shape)
    shape = list(p.shape)
    del loc[drop], shape[drop]
    z = torch.zeros(loc, dtype=dtype, device=p.device)
    dims = {(d if d < drop else d - 1): axes
            for d, axes in _dims(p).items() if d != drop}
    if not dims:
        return z
    return colshard.placed(z, p.device_mesh,
                           colshard.placements_of(p.device_mesh, dims),
                           shape)


def adafactor_init(params, state_dtype=torch.float32):
    def init_leaf(p):
        if _factored(tuple(p.shape)):
            nd = p.ndim
            return {"vr": _reduced_state(p, state_dtype, nd - 1),
                    "vc": _reduced_state(p, state_dtype, nd - 2)}
        return {"v": _zeros(state_dtype)(p)}
    return {"v": tree_map(init_leaf, params), "step": _step0(params)}


def _mean(x: torch.Tensor, dim, p, pdim) -> torch.Tensor:
    """The mean of ``x`` over its ``dim`` (the param's ``pdim``), over the
    whole dim where the mesh splits it."""
    out = x.mean(dim)
    axes = _dims(p).get(pdim % p.ndim, ())
    if not axes:
        return out
    n = colshard.batch_shard(p.device_mesh, axes)[0]
    return colshard.all_reduce(out, p.device_mesh, axes) / n


def adafactor_step(params, grads, state, lr, *, decay=0.99, eps=1e-30,
                   weight_decay=0.0, grad_clip=1.0, clip_threshold=1.0):
    grads, gnorm = clip_by_global_norm(grads, grad_clip)

    def upd(p, g, v):
        gf = colshard.local(g).to(torch.float32)
        g2 = gf * gf + eps
        if _factored(tuple(p.shape)):
            vr = (decay * colshard.local(v["vr"]).to(torch.float32)
                  + (1 - decay) * _mean(g2, -1, p, -1))
            vc = (decay * colshard.local(v["vc"]).to(torch.float32)
                  + (1 - decay) * _mean(g2, -2, p, -2))
            vr_mean = _mean(vr, -1, p, -2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr_mean[..., None, None], eps))
            u = gf / torch.sqrt(denom + eps)
            new_v = {"vr": colshard.like(v["vr"], vr.to(v["vr"].dtype)),
                     "vc": colshard.like(v["vc"], vc.to(v["vc"].dtype))}
        else:
            vv = (decay * colshard.local(v["v"]).to(torch.float32)
                  + (1 - decay) * g2)
            u = gf / torch.sqrt(vv + eps)
            new_v = {"v": colshard.like(v["v"], vv.to(v["v"].dtype))}
        # update clipping (Adafactor's RMS rule), over the whole leaf
        sq = torch.sum(u * u)
        axes = tuple(a for ax in _dims(p).values() for a in ax)
        if axes:
            sq = colshard.all_reduce(sq, p.device_mesh, axes)
        rms_u = torch.sqrt(sq / p.numel() + 1e-12)
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

    @_blockwise
    def upd(p, g, m):
        pf = p.to(torch.float32)
        gf = g.to(torch.float32) + weight_decay * pf
        m_new = momentum * colshard.local(m).to(torch.float32) + gf
        return (pf - lr * m_new).to(p.dtype), colshard.like(m, m_new.to(
            m.dtype))

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
