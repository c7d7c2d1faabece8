"""Monte-Carlo cell-variation robustness harness (paper §IV-E, Fig. 10),
counterpart of ``repro.eval.robustness``.

The sweep runs on the packed backend the config names (deploy, ref,
adc_free or binary): the packed planes are built once, and each
Monte-Carlo sample perturbs them at dispatch with its own ``Sampler``
(seed, sample index). Sample ``i`` draws the same theta field at every
sigma (common random numbers), so the sigma-monotonicity of the error
curve is not drowned by sampling noise. With a ``DriftSchedule`` the
grid is the request count ``t`` instead, and sample ``i``'s persistent
drift fields (cell, column) are the same at every ``t``.

Per-layer attribution re-evaluates each CIM conv on its clean input tap
with the same per-layer sampler the end-to-end forward uses, so a layer's
entry reflects the noise its own arrays inject.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, to_device
from repro_torch.api import conv2d, linear
from repro_torch.api.artifact import _packed_config
from repro_torch.core.cim_linear import CIMConfig
from repro_torch.core.variation import DriftSchedule, Sampler
from repro_torch.models import resnet


@dataclasses.dataclass
class RobustnessSweep:
    """Monte-Carlo sweep result: axis 0 indexes sigmas, axis 1 samples."""
    sigmas: Tuple[float, ...]
    n_samples: int
    acc: np.ndarray            # (n_sigma, n_samples) top-1 accuracy
    logit_err: np.ndarray      # (n_sigma, n_samples) relative logit error
    acc_clean: float           # no-noise accuracy

    @property
    def acc_mean(self) -> np.ndarray:
        return self.acc.mean(axis=1)

    @property
    def acc_std(self) -> np.ndarray:
        return self.acc.std(axis=1)

    @property
    def logit_err_mean(self) -> np.ndarray:
        return self.logit_err.mean(axis=1)


@dataclasses.dataclass
class LayerAttribution:
    """Layer-local error under the end-to-end noise realization."""
    name: str
    rel_err: float             # ||y_noisy - y_clean|| / ||y_clean||
    col_err: np.ndarray        # (C_out,) per-output-column relative error
    worst_col: int
    worst_col_err: float
    median_col_err: float


def monte_carlo_linear_error(packed: Dict[str, torch.Tensor], cfg: CIMConfig,
                             x, *, seed: int, sigmas: Sequence[float],
                             n_samples: int = 8, device=None) -> np.ndarray:
    """Relative output error per (sigma, sample) of a packed linear layer
    against its clean output. A cfg on a packed backend (deploy, ref,
    adc_free, binary) is evaluated on that backend; others pin to deploy.
    Returns (n_sigma, n_samples) float64; sigma <= 0 rows stay 0."""
    dev = resolve_device(device)
    dcfg = _packed_config(cfg)
    packed = to_device(packed, dev)
    x = torch.as_tensor(x, device=dev)
    y_clean = linear(x, packed, dcfg, compute_dtype=torch.float32)
    denom = float(torch.linalg.norm(y_clean)) + 1e-12
    out = np.zeros((len(sigmas), n_samples))
    for i in range(n_samples):
        sampler = Sampler(seed, sample=i)
        for si, sigma in enumerate(sigmas):
            if sigma <= 0.0:
                continue
            y = linear(x, packed, dcfg, variation=sampler,
                       variation_std=float(sigma), compute_dtype=torch.float32)
            out[si, i] = float(torch.linalg.norm(y - y_clean)) / denom
    return out


def monte_carlo_resnet(params: Dict, state: Dict, cfg: "resnet.ResNetConfig",
                       x, y, *, seed,
                       sigmas: Sequence[float] = (0.0, 0.1, 0.2, 0.3, 0.4),
                       n_samples: int = 4, batch: int = 128,
                       drift_schedule: Optional[DriftSchedule] = None,
                       drift_ts: Sequence[int] = (0, 64, 128, 256, 512),
                       device=None) -> RobustnessSweep:
    """Sigma-grid Monte-Carlo accuracy and logit-error sweep of a ResNet.
    ``params`` is the ``api.pack_model`` tree for a packed ``cfg.cim.mode``
    (deploy, adc_free, binary), or trainable params for emulate. Sample
    ``i`` uses ``Sampler(seed, sample=i)`` at every sigma; ``seed`` may
    also be a source with the sampler's ``at``/``for_layer`` (a drift
    source handing in fields drawn elsewhere).

    With ``drift_schedule`` the grid is ``drift_ts`` (request counts,
    reported in ``RobustnessSweep.sigmas``) and each evaluation perturbs
    with ``drift_schedule.at(t)``; a schedule with every rate at zero
    skips the evaluations (each reads the clean accuracy)."""
    dev = resolve_device(device)
    params, state = to_device(params, dev), to_device(state, dev)
    source = seed if hasattr(seed, "at") else Sampler(seed)
    n = len(x)
    xb_list = [torch.as_tensor(x[i:i + batch], device=dev)
               for i in range(0, n, batch)]
    yb_list = [np.asarray(y[i:i + batch]) for i in range(0, n, batch)]

    def logits(xb, **kw):
        return resnet.forward(params, state, xb, cfg, train=False, device=dev,
                              **kw)[0].to(torch.float32)

    clean = [logits(xb) for xb in xb_list]
    acc_clean = sum(int((lg.argmax(-1).cpu().numpy() == yb).sum())
                    for lg, yb in zip(clean, yb_list)) / n
    clean_sq = sum(float((lg.double() ** 2).sum()) for lg in clean)
    if drift_schedule is not None:
        grid = tuple(int(t) for t in drift_ts)
        clean_at = [drift_schedule.is_static_zero] * len(grid)
    else:
        grid = tuple(float(s) for s in sigmas)
        clean_at = [g <= 0.0 for g in grid]
    acc = np.zeros((len(grid), n_samples))
    err = np.zeros((len(grid), n_samples))
    for i in range(n_samples):
        sampler = source.at(i)
        for si, g in enumerate(grid):
            if clean_at[si]:
                acc[si, i] = acc_clean
                continue
            std = drift_schedule.at(g) if drift_schedule is not None else g
            correct, diff_sq = 0, 0.0
            for xb, yb, lg_c in zip(xb_list, yb_list, clean):
                lg = logits(xb, variation=sampler, variation_std=std)
                correct += int((lg.argmax(-1).cpu().numpy() == yb).sum())
                diff_sq += float(((lg - lg_c).double() ** 2).sum())
            acc[si, i] = correct / n
            err[si, i] = np.sqrt(diff_sq) / (np.sqrt(clean_sq) + 1e-12)
    return RobustnessSweep(sigmas=tuple(float(g) for g in grid),
                           n_samples=n_samples, acc=acc, logit_err=err,
                           acc_clean=acc_clean)


def per_layer_attribution(params: Dict, state: Dict,
                          cfg: "resnet.ResNetConfig", x, *, seed: int,
                          sigma: float, sample: int = 0,
                          device=None) -> Tuple[LayerAttribution, ...]:
    """Layer-local variation error under the noise the end-to-end forward
    draws for Monte-Carlo sample ``sample``: each CIM conv runs on its
    clean input tap with and without its own sampler
    (``resnet.layer_variation``). The per-column breakdown shows which
    output columns' scale factors absorb the noise."""
    dev = resolve_device(device)
    params, state = to_device(params, dev), to_device(state, dev)
    _, _, taps = resnet.forward(params, state, x, cfg, train=False,
                                return_taps=True, device=dev)
    sampler = Sampler(seed, sample=sample)
    out = []
    for lname, stride in resnet.conv_layer_names(cfg):
        blk, conv = lname.split(".")
        node, tap = params[blk][conv], taps[lname]
        y_clean = conv2d(tap, node, cfg.cim, stride=stride,
                         compute_dtype=torch.float32)
        y_noisy = conv2d(tap, node, cfg.cim, stride=stride,
                         variation=resnet.layer_variation(sampler, lname),
                         variation_std=float(sigma),
                         compute_dtype=torch.float32)
        diff = (y_noisy - y_clean).double()
        yc = y_clean.double()
        rel = float(torch.linalg.norm(diff) / (torch.linalg.norm(yc) + 1e-12))
        col_norm = torch.sqrt((yc ** 2).sum(dim=(0, 1, 2))) + 1e-12
        col_err = (torch.sqrt((diff ** 2).sum(dim=(0, 1, 2))) / col_norm
                   ).cpu().numpy()
        worst = int(np.argmax(col_err))
        out.append(LayerAttribution(
            name=lname, rel_err=rel, col_err=col_err, worst_col=worst,
            worst_col_err=float(col_err[worst]),
            median_col_err=float(np.median(col_err))))
    return tuple(out)
