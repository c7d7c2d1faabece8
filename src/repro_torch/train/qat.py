"""One-stage column-wise QAT of ResNet-20 on the synthetic class-conditional
image set: the counterpart of the JAX package's QAT harness,
``benchmarks/common.py:24-101`` (the paper's Table II CIFAR-10 settings).

``train_qat`` calibrates the activation and partial-sum scales on 128
training images, then trains every parameter (weights, LSQ scales, BN)
with the harness's momentum rule, ``m = 0.9 m + g`` and ``p -= lr m``,
under a cosine learning rate, on the emulate backend. ``widths``, ``hw``
and ``batch`` size the run: the reference's defaults (widths 8/16/32 at
16x16) for benchmarks, small ones for the CPU tests, the paper's 16/32/64
at 32x32 on the card.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tree_map
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.core.granularity import Granularity
from repro_torch.data.pipeline import (make_image_dataset,
                                       synth_classification_batch)
from repro_torch.models.resnet import ResNetConfig, calibrate, forward, init

HW = 16
N_CLASSES = 10
WIDTHS = (8, 16, 32)
MOMENTUM = 0.9
CALIBRATION_IMAGES = 128


def make_cim(gw: Granularity, gp: Granularity, *, psum_quant=True,
             weight_bits=3, cell_bits=1, act_bits=3, psum_bits=4,
             array=128, variation_std=0.0) -> CIMConfig:
    """Paper Table II CIFAR-10 column: 3-bit unsigned activations, 3-bit
    weights on 1-bit cells, low-bit partial sums, 128x128 arrays."""
    return CIMConfig(enabled=True, mode="emulate", weight_bits=weight_bits,
                     cell_bits=cell_bits, act_bits=act_bits,
                     psum_bits=psum_bits, array_rows=array, array_cols=array,
                     weight_granularity=gw, psum_granularity=gp,
                     act_signed=False, psum_quant=psum_quant,
                     variation_std=variation_std)


def resnet_cfg(cim: CIMConfig, *, widths=WIDTHS, hw: int = HW
               ) -> ResNetConfig:
    return ResNetConfig(name="resnet20-bench", depth=20, n_classes=N_CLASSES,
                        widths=tuple(widths), in_hw=hw, cim=cim)


def _data(seed=0, n=1536, *, hw: int = HW):
    """((x_train, y_train), (x_test, y_test)): the first quarter held out."""
    x, y = make_image_dataset(n_classes=N_CLASSES, hw=hw, n=n, seed=seed)
    n_test = n // 4
    return (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test])


def _loss_fn(params, state, xb, yb, cfg: ResNetConfig, device):
    """(mean cross-entropy, new BN state) of a train-mode forward."""
    logits, new_state = forward(params, state, xb, cfg, train=True,
                                device=device)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    yb = torch.as_tensor(yb, device=logp.device).to(torch.int64)
    return -torch.mean(torch.take_along_dim(logp, yb[:, None], 1)), new_state


def qat_step(params, state, mom, xb, yb, lr_t: float, cfg: ResNetConfig,
             device):
    """One QAT step: (params, BN state, momentum, loss tensor) after it.
    The inputs are left as they were."""
    leaves = []

    def track(p):
        p = p.detach().requires_grad_(True)
        leaves.append(p)
        return p

    tracked = tree_map(track, params)
    loss, new_state = _loss_fn(tracked, state, xb, yb, cfg, device)
    grads = iter(torch.autograd.grad(loss, leaves))
    g = tree_map(lambda _: next(grads), params)
    mom = tree_map(lambda m, gg: MOMENTUM * m + gg.to(torch.float32),
                    mom, g)
    # lr in float32, as the reference's jitted step receives it
    lr32 = float(np.float32(lr_t))
    params = tree_map(lambda p, m: (p.detach().to(torch.float32) - lr32 * m
                                     ).to(p.dtype), params, mom)
    return params, tree_map(torch.Tensor.detach, new_state), mom, \
        loss.detach()


def evaluate(params, state, cfg: ResNetConfig, x, y, batch=128, *,
             device=None) -> float:
    """Top-1 accuracy of an eval-mode forward over (x, y)."""
    dev = resolve_device(device)
    correct = 0
    with torch.no_grad():
        for i in range(0, len(x), batch):
            logits, _ = forward(params, state, x[i:i + batch], cfg,
                                train=False, device=dev)
            pred = torch.argmax(logits, dim=-1).cpu().numpy()
            correct += int((pred == y[i:i + batch]).sum())
    return correct / len(x)


def train_qat(cim: CIMConfig, *, steps=150, batch=64, lr=0.05, seed=0,
              params=None, state=None, data=None, widths=WIDTHS,
              hw: int = HW, device=None,
              on_step: Optional[Callable] = None) -> Dict:
    """One-stage QAT (the paper's scheme), from scratch or from ``params``
    and ``state``.

    Without ``params`` the model is initialised from ``seed`` and
    calibrated on the first 128 training images. ``on_step(it, params,
    state, mom)`` is called after each step (checkpoints, timing).
    Returns params, state, momentum, the per-step losses, the held-out
    accuracy, the training wall time and the config."""
    dev = resolve_device(device)
    cfg = resnet_cfg(cim, widths=widths, hw=hw)
    (xtr, ytr), (xte, yte) = data or _data(seed, hw=hw)
    if params is None:
        params, state = init(seed, cfg, device=dev)
        if cfg.cim.enabled:
            with torch.no_grad():
                params = calibrate(params, state,
                                   xtr[:CALIBRATION_IMAGES], cfg, device=dev)
    mom = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    t0 = time.perf_counter()
    losses = []
    for it in range(steps):
        xb, yb = synth_classification_batch(xtr, ytr, batch, it, seed)
        lr_t = lr * 0.5 * (1 + np.cos(np.pi * it / steps))
        params, state, mom, loss = qat_step(params, state, mom, xb, yb, lr_t,
                                            cfg, dev)
        losses.append(loss)
        if on_step is not None:
            on_step(it, params, state, mom)
    losses = [float(v) for v in losses]       # one host sync at the end
    train_time = time.perf_counter() - t0
    acc = evaluate(params, state, cfg, xte, yte, device=dev)
    return {"params": params, "state": state, "mom": mom, "acc": acc,
            "train_time": train_time, "losses": losses, "cfg": cfg}
