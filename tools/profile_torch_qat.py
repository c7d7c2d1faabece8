#!/usr/bin/env python3
"""Where the time of one QAT step of the port goes, on a card.

Runs ``repro_torch.train.qat.qat_step`` on ResNet-20 at full width with
the paper's CIFAR-10 settings (the configuration of ``chip_smoke.py``
phase 11: 3-bit weights on 1-bit cells, 3-bit unsigned activations,
4-bit partial sums, 128x128 arrays, column-wise scales, batch 128,
32x32), after calibration on 128 images, and prints:

* the step, and its train-mode forward alone (the loss with the autograd
  graph built), by CUDA events: medians over ``--steps`` steps; the rest
  of the step is the backward and the momentum update;
* the host time of fetching one batch (``synth_classification_batch``
  and the copy to the card), which ``train_qat`` adds to each step;
* under ``torch.profiler``: the device time per step, the device's busy
  share (summed kernel and copy time over wall time), and the CUDA
  kernels that take the most device time per step.

    python3 tools/profile_torch_qat.py [--batch 128] [--steps 20]

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_qat: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree_map
    from repro_torch.data.pipeline import synth_classification_batch
    from repro_torch.models import resnet
    from repro_torch.train import qat

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)

    dev = torch.device("cuda")
    cfg = qat.resnet_cfg(qat.make_cim("column", "column"), widths=(16, 32, 64),
                         hw=32)
    (xtr, ytr), _ = qat._data(seed=0, n=4096, hw=32)
    params, state = resnet.init(0, cfg, device=dev)
    with torch.no_grad():
        params = resnet.calibrate(params, state, xtr[:128], cfg, device=dev)
    mom = tree_map(torch.zeros_like, params)

    def batch(it):
        xb, yb = synth_classification_batch(xtr, ytr, args.batch, it)
        return (torch.as_tensor(xb, device=dev),
                torch.as_tensor(yb, device=dev))

    def step(it):
        nonlocal params, state, mom
        xb, yb = batch(it)
        params, state, mom, _ = qat.qat_step(params, state, mom, xb, yb,
                                             0.05, cfg, dev)

    def forward(it):
        xb, yb = batch(it)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        return qat._loss_fn(leaves, state, xb, yb, cfg, dev)

    def timed(fn, n):
        out = []
        for it in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(it)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out))

    for it in range(3):                                  # warm-up
        step(it)
    torch.cuda.synchronize()
    step_ms = timed(step, args.steps)
    fwd_ms = timed(forward, args.steps)
    t0 = time.perf_counter()
    for it in range(args.steps):
        synth_classification_batch(xtr, ytr, args.batch, it)
    fetch_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    print(f"batch {args.batch}: QAT step {step_ms:.3f} ms (CUDA events, "
          f"median of {args.steps}): train-mode forward {fwd_ms:.3f} ms, "
          f"backward and momentum update {step_ms - fwd_ms:.3f} ms; batch "
          f"draw on the host {fetch_ms:.3f} ms; {smi}", flush=True)

    cuda_type = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(args.steps):
            step(it)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda_type]
    print(f"under the profiler: wall {wall_ms:.3f} ms per step", flush=True)
    if not kernels:
        print("the profiler traced no device time: device busy share not "
              "measured", flush=True)
        return 0
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.steps
    n_kernels = sum(e.count for e in kernels) // args.steps
    print(f"device time {dev_ms:.3f} ms per step ({n_kernels} kernels), busy "
          f"share {dev_ms / wall_ms:.3f}, idle share "
          f"{1 - dev_ms / wall_ms:.3f}", flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:args.top]:
        ms = e.self_device_time_total / 1e3 / args.steps
        print(f"  {ms:8.4f} ms/step {100 * ms / dev_ms:5.1f}%  "
              f"{e.count // args.steps:5d}x  {e.key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
