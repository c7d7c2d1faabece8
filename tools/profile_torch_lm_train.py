#!/usr/bin/env python3
"""Where the time of one LM train step of the port goes, on a card.

Runs the port's LM train step (``repro_torch.train.trainer``) on
qwen3-0.6b at its published widths under the training launcher's CIM
config (``--cim emulate``: 4-bit weights on 2-bit cells, 6-bit partial
sums, 128x128 arrays, column-wise scales), AdamW, on batches of the LM
stream, as ``chip_smoke.py`` phase 16 trains it, and prints:

* the step split into its forward (the loss with the autograd graph
  built), its backward (``torch.autograd.grad``, each block recomputed
  under remat) and its optimizer update, by CUDA events: medians over
  ``--steps`` steps;
* under ``torch.profiler``: the device time per step, the device's busy
  share (summed kernel and copy time over wall time), the CUDA kernels
  that take the most device time per step, and the operators that take
  the most host time.

    python3 tools/profile_torch_lm_train.py [--arch qwen3-0.6b] \\
        [--layers N] [--batch 8] [--seq 256] [--steps 5]

``--layers`` cuts the depth (default: the published depth);
``--deterministic`` runs the step on deterministic algorithms, as phase
16 trains. Needs a CUDA card; exits non-zero without one.
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
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_lm_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.data.pipeline import make_lm_pipeline
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.optim.schedule import cosine_warmup
    from repro_torch.train.trainer import lm_loss_fn, loss_and_grads

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.deterministic:
        import os
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)

    dev = torch.device("cuda")
    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=4, cell_bits=2,
                    psum_bits=6, array_rows=128, array_cols=128)
    cfg = get_config(args.arch, cim=cim)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    model = get_model(cfg)
    run = RunConfig(lr=3e-4, total_steps=40, warmup_steps=4)
    opt = make_optimizer(run.optimizer)
    params = init_params(model.specs(cfg), 0, device=dev)
    state = opt.init(params, torch.float32)
    pipe = make_lm_pipeline(vocab=cfg.vocab, seq_len=args.seq,
                            global_batch=args.batch)
    loss_fn = lm_loss_fn(model, cfg)
    marks = {}

    def timed_loss(p, b):
        marks["fwd0"].record()
        out = loss_fn(p, b)
        marks["fwd1"].record()
        return out

    def step():
        nonlocal params, state
        for k in ("fwd0", "fwd1", "bwd1", "opt1"):
            marks[k] = torch.cuda.Event(enable_timing=True)
        batch = {"tokens": torch.as_tensor(next(pipe)["tokens"]).to(dev)}
        _, grads = loss_and_grads(timed_loss, params, batch)
        marks["bwd1"].record()
        lr = cosine_warmup(state["step"], base_lr=run.lr,
                           warmup_steps=run.warmup_steps,
                           total_steps=run.total_steps)
        params, state, _ = opt.step(params, grads, state, lr,
                                    weight_decay=run.weight_decay,
                                    grad_clip=run.grad_clip)
        marks["opt1"].record()

    step()                                              # warm-up
    torch.cuda.synchronize()
    parts = {"forward": [], "backward": [], "optimizer": [], "step": []}
    for _ in range(args.steps):
        step()
        torch.cuda.synchronize()
        m = marks
        parts["forward"].append(m["fwd0"].elapsed_time(m["fwd1"]))
        parts["backward"].append(m["fwd1"].elapsed_time(m["bwd1"]))
        parts["optimizer"].append(m["bwd1"].elapsed_time(m["opt1"]))
        parts["step"].append(m["fwd0"].elapsed_time(m["opt1"]))
    med = {k: float(np.median(v)) for k, v in parts.items()}
    print(f"{cfg.name} at {cfg.n_layers} layers, batch {args.batch} x "
          f"{args.seq}, emulate, AdamW"
          + (", deterministic algorithms" if args.deterministic else "")
          + f": step {med['step']:.2f} ms (CUDA "
          f"events, median of {args.steps}): forward {med['forward']:.2f}, "
          f"backward {med['backward']:.2f} (each block recomputed), "
          f"optimizer {med['optimizer']:.2f}; "
          f"{args.batch * args.seq / med['step'] * 1e3:.0f} tokens/s; max "
          f"memory allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB; {smi}", flush=True)

    cuda_type = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    events = prof.key_averages()
    kernels = [e for e in events
               if getattr(e, "device_type", None) == cuda_type]
    print(f"under the profiler: wall {wall_ms:.2f} ms per step", flush=True)
    if kernels:
        dev_ms = (sum(e.self_device_time_total for e in kernels) / 1e3
                  / args.steps)
        n_kernels = sum(e.count for e in kernels) // args.steps
        print(f"device time {dev_ms:.2f} ms per step ({n_kernels} kernels), "
              f"busy share {dev_ms / wall_ms:.3f}, idle share "
              f"{1 - dev_ms / wall_ms:.3f}", flush=True)
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in kernels[:args.top]:
            ms = e.self_device_time_total / 1e3 / args.steps
            print(f"  {ms:9.2f} ms/step {100 * ms / dev_ms:5.1f}%  "
                  f"{e.count // args.steps:6d}x  {e.key[:110]}", flush=True)
    else:
        print("the profiler traced no device time: device busy share not "
              "measured", flush=True)
    ops = [e for e in events if getattr(e, "device_type", None) != cuda_type]
    ops.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    print("operators by host time (self):", flush=True)
    for e in ops[:args.top]:
        ms = e.self_cpu_time_total / 1e3 / args.steps
        print(f"  {ms:9.2f} ms/step  {e.count // args.steps:6d}x  "
              f"{e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
