"""Packed evaluation of a CIM ResNet, clean or under cell variation: the
closed loop a throughput-minded eval or Monte-Carlo sweep runs.

Set-up (counted in ``setup_s``): raw weights and images from the seed,
the port's calibration (``resnet.calibrate``), BN statistics from one
train-mode forward of the calibrated model (momentum 0), ``pack_model``,
the cell-variation fields, two warm-up batches. The window keeps
``inflight`` batches queued on the device: batch i + 1 is dispatched
before the predictions of batch i are read back. With ``variation`` each
batch is a new realization: theta set i mod T at sigma i mod len(sigmas)
on images i mod P.

``correct``: the logits of a seeded sample of the window's realizations
against the plain reference's, worked out again from the raw weights and
images (``reference/resnet.py``).
"""
from __future__ import annotations

import dataclasses
import math
import random

import torch

from .. import inputs, loop
from ..reference import resnet as reference
from .resnet_port import port_config, port_params

#: seconds of work in the traced slice
SLICE_S = 1.5


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| over a batch's logits."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).abs().max() / want.abs().max())


class Eval:
    def __init__(self, ctx):
        from repro_torch.api import pack_model
        from repro_torch.models import resnet
        self.ctx, self.resnet = ctx, resnet
        config, tr, dev = ctx.config, ctx.traffic, ctx.device
        cfg, cim = port_config(config)
        self.batch = tr["batch"]
        self.raw = inputs.raw_weights(config, ctx.seed, dev)
        self.x_cal, _ = inputs.images(config, ctx.seed,
                                      tr["calibration_images"],
                                      "calibration", dev)
        pool, _ = inputs.images(config, ctx.seed,
                                self.batch * tr["pool_batches"], "pool", dev)
        self.pool = list(pool.split(self.batch))
        var = tr.get("variation")
        self.sigmas = var["sigmas"] if var else [0.0]
        self.thetas = (inputs.thetas(config, ctx.seed, var["theta_sets"], dev)
                       if var else None)
        with torch.no_grad():
            params, state = port_params(self.raw, config, cim)
            params = resnet.calibrate(params, state, self.x_cal, cfg,
                                      device=dev)
            _, self.state = resnet.forward(
                params, state, self.x_cal,
                dataclasses.replace(cfg, bn_momentum=0.0), train=True,
                device=dev)
            self.packed = pack_model(params, cim, device=dev)
        self.cfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
        n_theta = len(self.thetas) if self.thetas else 1
        self.period = math.lcm(len(self.pool), n_theta, len(self.sigmas))
        # one pinned buffer per queued batch and one being filled: a batch's
        # predictions are copied out right behind its forward, so reading
        # them back waits for that batch alone
        pinned = dev.type == "cuda"
        self.host = [torch.empty(self.batch, dtype=torch.int64,
                                 pin_memory=pinned)
                     for _ in range(tr["inflight"] + 1)]

    def realization(self, i: int):
        """(images, theta or None, sigma) of batch i."""
        r = i % self.period
        theta = self.thetas[r % len(self.thetas)] if self.thetas else None
        return (self.pool[r % len(self.pool)], theta,
                self.sigmas[r % len(self.sigmas)])

    def dispatch(self, i: int):
        """Enqueue batch i: (logits, the predictions' host copy, an event
        behind the copy)."""
        x, theta, sigma = self.realization(i)
        kw = ({} if theta is None
              else dict(variation=theta, variation_std=sigma))
        with torch.no_grad():
            logits, _ = self.resnet.forward(self.packed, self.state, x,
                                            self.cfg, train=False,
                                            device=self.ctx.device, **kw)
            buf = self.host[i % len(self.host)]
            buf.copy_(torch.argmax(logits, dim=-1), non_blocking=True)
        event = None
        if logits.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return logits, buf, event


def _wait(handle) -> None:
    """Until a batch's predictions are on the host."""
    event = handle[2]
    if event is not None:
        event.synchronize()


def run(ctx):
    model = Eval(ctx)
    depth = ctx.traffic["inflight"]
    loop.closed_loop(model.dispatch, _wait, 0, depth, count=2)   # warm-up
    kept = {}
    win = loop.measure(
        ctx, model.dispatch, _wait, 2, depth, slice_s=SLICE_S,
        unit_size=model.batch,
        on_done=lambda j, h: kept.__setitem__(j % model.period, h[0]))
    out = {
        "attempted": win.units, "failed": 0,
        "end_to_end": {ctx.traffic["metric"]:
                       win.units * model.batch / win.seconds},
        "memory_peak_bytes": ctx.memory_peak(),
        "spans": {"dispatch_s": win.dispatch_s, "unit": model.batch},
        "slice": win.slice,
    }
    out["check"] = _checker(ctx, model, kept)
    return out


def _checker(ctx, model: Eval, kept: dict):
    """Frees the port's state and returns the check: the reference's logits
    of a seeded sample of the window's realizations."""
    rng = random.Random(ctx.seed)
    picks = rng.sample(sorted(kept), min(ctx.cell["check_batches"], len(kept)))
    cases = []
    for r in picks:
        x, theta, sigma = model.realization(r)
        cases.append({"x": x, "theta": theta, "sigma": sigma,
                      "got": kept[r]})
    raw, x_cal, config = model.raw, model.x_cal, ctx.config
    model.packed = model.state = model.pool = model.thetas = None
    kept.clear()

    def check(control: bool = False):
        """{"logit_gap": the program's}; with ``control`` also the
        control's: the reference one precision lower (TF32), in the
        program's place."""
        want = reference.eval_logits(config, raw, x_cal, cases)
        out = {"logit_gap": max(logit_gap(c["got"], w)
                                for c, w in zip(cases, want))}
        if control:
            ctl = reference.eval_logits(config, raw, x_cal, cases,
                                        tf32=True)
            out["control.logit_gap"] = max(logit_gap(c, w)
                                           for c, w in zip(ctl, want))
        return out
    return check
