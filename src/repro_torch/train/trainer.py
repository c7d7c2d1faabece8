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

Under a session mesh the tree may hold expert banks placed over
``"model"`` (``nn.module.shard_params``): such a leaf is differentiated
through its local block, and its gradient is the rank's block of the
single device's, placed alike. The expert-parallel MoE sums the
replicated leaves' gradients over the mesh inside its backward
(``core.colshard.grad_psum``), so every rank gets them whole, once. The
optimizer updates each rank's blocks locally and reduces the gradient
norm over the mesh (``optim.optimizer.global_norm``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import colshard
from repro_torch.models.registry import ModelFns
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.optim.schedule import cosine_warmup

_FSDP = ("RunConfig(fsdp=True): sharding params and optimizer state over "
         "a data axis is not ported yet (ROADMAP queue 1, item 12b.3)")


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
    if mask is None:
        return ce.mean()
    mask = mask.to(torch.float32)
    return (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


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


def make_train_step(model: ModelFns, cfg: ModelConfig, run: RunConfig,
                    loss_fn: Optional[Callable] = None):
    """Returns (init_state, train_step).

    init_state(params) -> opt_state
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    """
    if run.fsdp:
        raise NotImplementedError(_FSDP)
    opt = make_optimizer(run.optimizer)
    state_dtype = (torch.bfloat16 if run.opt_state_dtype == "bfloat16"
                   else torch.float32)
    loss_fn = loss_fn or lm_loss_fn(model, cfg)

    def init_state(params):
        return opt.init(params, state_dtype)

    def grads_of(params, batch):
        if run.accum_steps <= 1:
            return loss_and_grads(loss_fn, params, batch)
        # microbatch accumulation in float32, in microbatch order
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(tree_leaves(params)).device)
        g_sum = tree_map(lambda p: torch.zeros(
            colshard.local(p).shape, dtype=torch.float32, device=p.device),
            params)
        for mb in _microbatches(batch, run.accum_steps):
            loss, g = loss_and_grads(loss_fn, params, mb)
            loss_sum = loss_sum + loss
            g_sum = tree_map(lambda a, b: a + colshard.local(b).to(
                torch.float32), g_sum, g)
        inv = 1.0 / run.accum_steps
        return loss_sum * inv, tree_map(lambda p, a: colshard.like(p, a * inv),
                                        params, g_sum)

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
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
