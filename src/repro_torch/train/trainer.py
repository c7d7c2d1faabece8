"""LM training step of the port (counterpart of ``repro.train.trainer``):
the next-token loss of every family, microbatch gradient accumulation and
the optimizer wiring.

``make_train_step`` returns ``(init_state, train_step)``;
``train_step(params, opt_state, batch)`` takes the param tree as plain
tensors (no leaf needs ``requires_grad``), differentiates the loss with
``torch.autograd.grad`` over every leaf and returns new trees (the inputs
are left as they were) and the metrics ``loss``, ``grad_norm``, ``lr`` and
``step`` as tensors on the params' device. The forward is the family's
``models.registry`` forward: under ``cfg.cim.mode == "emulate"`` the
column-wise LSQ / straight-through path; a ``deploy`` tree holds integer
digit planes, which have no gradient, and is refused as the reference's
``jax.value_and_grad`` refuses it.

Under a session mesh the tree may hold leaves placed over it
(``nn.module.shard_params``: expert banks, raw weights over ``"model"``,
FSDP's embed axis over the batch axes): such a leaf is differentiated
through its local block, and its gradient is the rank's block of the
single device's, placed alike. The forward's collectives carry the
gradients: an FSDP gather reduce-scatters in its backward, a
column-parallel input sums its ranks' parts (``core.colshard``). With
batch axes of more than one rank the step is data parallel (each rank its
rows, the global masked mean, replicated leaves' gradients summed over
the batch axes). The optimizer updates each rank's blocks locally and
reduces the gradient norm over the mesh (``optim.optimizer.global_norm``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import colshard
from repro_torch.models.registry import ModelFns
from repro_torch.nn.module import (batch_parallel, batch_ranks, current_mesh,
                                   data_parallel)
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.optim.schedule import cosine_warmup

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean CE over valid positions; logits promoted to float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].to(torch.long),
                                dim=-1)[..., 0]
    ce = logz - gold
    if label_smoothing > 0:
        ce = ((1 - label_smoothing) * ce
              + label_smoothing * (logz - logits.mean(dim=-1)))
    dp = batch_parallel()
    if dp is None:
        if mask is None:
            return ce.mean()
        mask = mask.to(torch.float32)
        return (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    # a data parallel step: the global masked mean, as the reference's one
    # program computes it (sums over the batch axes, then one divide), not
    # the mean of the ranks' means
    mesh, axes = dp
    if mask is None:
        return colshard.psum(ce.sum(), mesh, axes) / float(
            ce.numel() * batch_ranks())
    mask = mask.to(torch.float32)
    return colshard.psum((ce * mask).sum(), mesh, axes) / torch.clamp_min(
        colshard.all_reduce(mask.sum(), mesh, axes), 1.0)


def lm_loss_fn(model: ModelFns, cfg: ModelConfig):
    """Next-token loss for every family (llava prepends its image tokens,
    whose positions are dropped; whisper conditions on its frames)."""
    def loss(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        extra = batch.get("frontend")
        logits = model.forward(params, inp, cfg, extra)
        if cfg.family == "llava" and extra is not None:
            # the image tokens, however many the front end made of its
            # input: the reference drops extra.shape[1], which is the
            # image height for raw images (ROADMAP fault 17)
            logits = logits[:, logits.shape[1] - inp.shape[1]:]
        return cross_entropy(logits, labels)
    return loss


def loss_and_grads(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, object]:
    """(loss, gradient tree) of ``loss_fn(params, batch)`` with respect to
    every leaf of ``params``: ``jax.value_and_grad``. A leaf the loss does
    not reach gets zeros, as in JAX. Integer leaves raise TypeError."""
    leaves = []

    def track(path, p):
        if not torch.is_floating_point(p):
            raise TypeError(
                f"grad requires floating-point leaves, got {p.dtype} at "
                f"{path}: a deploy tree holds packed integer digit planes; "
                "train under emulate and pack the result")
        loc = colshard.local(p).detach().requires_grad_(True)
        leaves.append(loc)
        return colshard.like(p, loc)

    tracked = _map_with_path(track, params)
    loss = loss_fn(tracked, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda p: colshard.like(p, next(it)),
                                   params)


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, f"{path}/{i}")
                for i, v in enumerate(tree)]
    return fn(path or "<root>", tree)


def _microbatches(batch: Dict, n: int):
    def split(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape(n, b // n, *x.shape[1:])
    micro = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in micro.items()} for i in range(n)]


def _data_axes(mesh) -> Tuple[str, ...]:
    """The session mesh's batch axes of more than one rank."""
    from repro_torch.launch.mesh import batch_axes
    return tuple(a for a in batch_axes(mesh)
                 if colshard.mesh_shards(mesh, a) > 1)


def _rows(batch: Dict, mesh, axes) -> Dict:
    """This rank's rows of every batch leaf over ``axes``, as the
    reference's ``batch_shardings`` place ``tokens`` and ``frontend``."""
    n, i = colshard.batch_shard(mesh, axes)

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not divide "
                             f"over {n} ranks of {axes}")
        w = x.shape[0] // n
        return x[i * w:(i + 1) * w]
    return {k: take(v) for k, v in batch.items()}


def _sum_over_batch(grads, mesh, axes):
    """Each gradient summed over the batch ``axes`` that do not split its
    leaf: a replicated leaf's gradient holds only this rank's rows' part
    (an FSDP leaf's was reduce-scattered in the backward)."""
    def one(g):
        split = {a for ax in (colshard.sharded_dims(g).values()
                              if colshard.is_col_sharded(g) else ())
                 for a in ax}
        over = tuple(a for a in axes if a not in split)
        if not over:
            return g
        return colshard.like(g, colshard.all_reduce(colshard.local(g), mesh,
                                                    over))
    return tree_map(one, grads)


def batch_grads(loss_fn: Callable, params, batch: Dict,
                accum_steps: int = 1):
    """(loss, gradient tree) of ``loss_fn`` on the global ``batch``, over
    ``accum_steps`` microbatches accumulated in float32 in microbatch
    order: one step's gradients. Under a session mesh with batch axes of
    more than one rank each rank takes its rows of every microbatch
    (``nn.module.data_parallel``: the loss is the global mean and LSQ's g
    counts the global batch), and the replicated leaves' gradients are
    summed over the batch axes after the last microbatch."""
    mesh = current_mesh()
    axes = _data_axes(mesh) if mesh is not None else ()

    def micro(mb):
        if not axes:
            return loss_and_grads(loss_fn, params, mb)
        with data_parallel(mesh, axes):
            return loss_and_grads(loss_fn, params, _rows(mb, mesh, axes))

    if accum_steps <= 1:
        loss, grads = micro(batch)
    else:
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(tree_leaves(params)).device)
        g_sum = tree_map(lambda p: torch.zeros(
            colshard.local(p).shape, dtype=torch.float32, device=p.device),
            params)
        for mb in _microbatches(batch, accum_steps):
            loss, g = micro(mb)
            loss_sum = loss_sum + loss
            g_sum = tree_map(lambda a, b: a + colshard.local(b).to(
                torch.float32), g_sum, g)
        inv = 1.0 / accum_steps
        loss, grads = loss_sum * inv, tree_map(
            lambda p, a: colshard.like(p, a * inv), params, g_sum)
    return loss, (_sum_over_batch(grads, mesh, axes) if axes else grads)


def make_train_step(model: ModelFns, cfg: ModelConfig, run: RunConfig,
                    loss_fn: Optional[Callable] = None):
    """Returns (init_state, train_step).

    init_state(params) -> opt_state
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

    Under a session mesh with batch axes of more than one rank the step is
    data parallel: ``batch`` is the global batch, each rank takes its rows
    of every microbatch, the loss is the global masked mean, and the
    replicated leaves' gradients are summed over the batch axes.
    ``run.fsdp`` is a placement (``launch.cells.build_cell``,
    ``nn.module.shard_params``): the step follows whatever placements the
    params carry."""
    opt = make_optimizer(run.optimizer)
    state_dtype = (torch.bfloat16 if run.opt_state_dtype == "bfloat16"
                   else torch.float32)
    loss_fn = loss_fn or lm_loss_fn(model, cfg)

    def init_state(params):
        return opt.init(params, state_dtype)

    def train_step(params, opt_state, batch):
        loss, grads = batch_grads(loss_fn, params, batch, run.accum_steps)
        lr = cosine_warmup(opt_state["step"], base_lr=run.lr,
                           warmup_steps=run.warmup_steps,
                           total_steps=run.total_steps)
        params, opt_state, gnorm = opt.step(
            params, grads, opt_state, lr,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "step": opt_state["step"]}
        return params, opt_state, metrics

    return init_state, train_step


def make_eval_step(model: ModelFns, cfg: ModelConfig,
                   loss_fn: Optional[Callable] = None):
    loss_fn = loss_fn or lm_loss_fn(model, cfg)

    def eval_step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return eval_step
