"""Column-wise QAT of a CIM ResNet: the port's ``train.qat.qat_step``
(emulate backend, LSQ on weights, activations and partial sums, momentum
SGD), step after step on seeded images and labels held on the device.

Set-up (counted in ``setup_s``): raw weights and images from the seed, the
port's calibration, then the first ``checked_steps`` steps through the
window's own call and feed, on distinct batches; what they produced (each
step's loss, the first gradient as the optimizer holds it, the change of
every parameter and BN statistic) is kept for the check, and the same
state goes on into the window. The window keeps ``inflight`` steps
queued and reports its seconds over the steps completed.

``correct``: the reference (``reference/train.py``) repeats the
calibration and the first steps from the raw weights and batches; the
numbers are each step's loss, and per leaf the norms of the first
gradient and of the change, the worst leaf's gap measured against the
larger of its own reference norm and the median leaf's.
"""
from __future__ import annotations

import statistics

import torch

from .. import inputs, loop
from ..reference import train as reference
from .resnet_port import port_config, port_params

#: seconds of work in the traced slice
SLICE_S = 2.0
#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out of the change
DEAD_GRAD = 1e-3


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float32)))
            for k, v in tree.items()}


def worst_gap(got: dict, want: dict, keep=None) -> float:
    """max over leaves of |got - want| / max(want, median of want)."""
    keys = [k for k in want if keep is None or keep(k)]
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in keys)


class Qat:
    def __init__(self, ctx):
        from repro_torch import tree_map
        from repro_torch.models import resnet
        from repro_torch.train import qat
        self.ctx, self.qat = ctx, qat
        config, tr, dev = ctx.config, ctx.traffic, ctx.device
        self.cfg, cim = port_config(config)
        self.batch, self.lr = tr["batch"], tr["lr"]
        self.raw = inputs.raw_weights(config, ctx.seed, dev)
        self.x_cal, _ = inputs.images(config, ctx.seed,
                                      tr["calibration_images"],
                                      "calibration", dev)
        x, y = inputs.images(config, ctx.seed,
                             self.batch * tr["pool_batches"], "train", dev)
        self.xs, self.ys = list(x.split(self.batch)), list(y.split(self.batch))
        params, self.state = port_params(self.raw, config, cim)
        with torch.no_grad():
            self.params = resnet.calibrate(params, self.state, self.x_cal,
                                           self.cfg, device=dev)
        self.mom = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), self.params)
        self.losses = []

    def step(self, i: int):
        j = i % len(self.xs)
        self.params, self.state, self.mom, loss = self.qat.qat_step(
            self.params, self.state, self.mom, self.xs[j], self.ys[j],
            self.lr, self.cfg, self.ctx.device)
        self.losses.append(loss)
        event = None
        if loss.is_cuda:
            event = torch.cuda.Event()
            event.record()
        return event


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


def run(ctx):
    tr = ctx.traffic
    model = Qat(ctx)
    n_check = ctx.cell["checked_steps"]
    before = {"params": flat(model.params), "state": flat(model.state)}
    for i in range(n_check):
        model.step(i)
        if i == 0:
            first_grad = norms(flat(model.mom))     # m = 0.9 * 0 + g
    got = {"losses": [float(v) for v in model.losses],
           "grad": first_grad,
           "change": norms({k: v - before["params"][k]
                            for k, v in flat(model.params).items()}),
           "bn": norms({k: v - before["state"][k]
                        for k, v in flat(model.state).items()})}
    del before
    model.losses.clear()
    win = loop.measure(ctx, model.step, _wait, n_check, tr["inflight"],
                       slice_s=SLICE_S)
    steps = len(model.losses)
    finite = int(torch.isfinite(torch.stack(model.losses)).sum())
    out = {
        "attempted": steps, "failed": steps - finite,
        "end_to_end": {"train_step_ms": 1e3 * win.seconds / win.units},
        "memory_peak_bytes": ctx.memory_peak(),
        "spans": {"dispatch_s": win.dispatch_s, "unit": 1},
        "slice": win.slice,
    }
    cases = {"raw": model.raw, "x_cal": model.x_cal,
             "batches": list(zip(model.xs, model.ys))[:n_check]}
    config, lr = ctx.config, model.lr
    del model

    def check(control: bool = False, faults: bool = False):
        """The program's numbers; with ``control`` also the control's (the
        reference one precision lower, TF32, in the program's place); with
        ``faults`` those of half of each batch left out (the mean over the
        rest)."""
        want = reference_run(config, cases, lr)
        numbers = compare(got, want)
        if control:
            low = reference_run(config, cases, lr, tf32=True)
            numbers.update({f"control.{k}": v
                            for k, v in compare(low, want).items()})
        if faults:
            half = dict(cases, batches=[(x[:len(x) // 2], y[:len(y) // 2])
                                        for x, y in cases["batches"]])
            bad = reference_run(config, half, lr)
            numbers.update({f"half_batch.{k}": v
                            for k, v in compare(bad, want).items()})
        return numbers

    out["check"] = check
    return out


def reference_run(config, cases, lr: float, tf32: bool = False) -> dict:
    """The reference's readings of the checked steps, as ``run`` keeps the
    program's."""
    tr = reference.Trainer(config, cases["raw"], cases["x_cal"], tf32)
    before = {"params": dict(tr.params), "state": dict(tr.state)}
    losses, first = [], None
    for x, y in cases["batches"]:
        loss, grads = tr.step(x, y, lr)
        losses.append(float(loss))
        if first is None:
            first = norms(grads)
    return {"losses": losses, "grad": first,
            "change": norms({k: v - before["params"][k]
                             for k, v in tr.params.items()}),
            "bn": norms({k: v - before["state"][k]
                         for k, v in tr.state.items()})}


def compare(got: dict, want: dict) -> dict:
    med = statistics.median(want["grad"].values())
    live = [k for k in want["grad"] if want["grad"][k] >= DEAD_GRAD * med]
    median_change = lambda r: statistics.median(r["change"][k] for k in live)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], want["losses"])),
        "first_loss_gap": abs(got["losses"][0] - want["losses"][0])
        / abs(want["losses"][0]),
        "grad_gap": worst_gap(got["grad"], want["grad"]),
        "change_gap": worst_gap(got["change"], want["change"],
                                lambda k: k in live),
        "median_change_gap": abs(median_change(got) - median_change(want))
        / median_change(want),
        "bn_gap": worst_gap(got["bn"], want["bn"]),
    }
