#!/usr/bin/env python3
"""Where the time of the port's packed ResNet-20 inference goes, on a card.

Runs the main path of ``chip_smoke.py`` (ResNet-20 at full width, the
paper's CIFAR-10 settings, batch 256, int8 and int4 planes) under
``torch.profiler`` and prints, per pack dtype, and for the int8 pack
under cell variation at chip_smoke's sigma of 0.3 (one ``Sampler``
realization, the float-plane path): the wall time per batch, the
device's busy share (summed kernel and copy time over wall time), and
the CUDA kernels that take the most device time per forward.

    python3 tools/profile_torch_deploy.py [--batch 256] [--forwards 5]

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the cell variation of the varied forward, as chip_smoke.py's
SIGMA = 0.3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_deploy: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import pack_model
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.core.variation import Sampler
    from repro_torch.data.pipeline import make_image_dataset
    from repro_torch.models import resnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)

    cim = CIMConfig(enabled=True, mode="emulate", weight_bits=3, cell_bits=1,
                    act_bits=3, psum_bits=4, array_rows=128, array_cols=128,
                    act_signed=False)
    cfg = resnet.ResNetConfig(name="resnet20-cifar10", depth=20, n_classes=10,
                              widths=(16, 32, 64), in_hw=32, cim=cim)
    x_all, _ = make_image_dataset(n_classes=10, hw=32, n=2 * args.batch,
                                  seed=0)
    xc = torch.as_tensor(x_all[:args.batch], device="cuda")
    xb = torch.as_tensor(x_all[args.batch:], device="cuda")
    params, state = resnet.init(0, cfg)
    params = resnet.calibrate(params, state, xc, cfg)
    dcfg = dataclasses.replace(cfg, cim=cim.replace(mode="deploy"))
    cuda_type = torch.autograd.DeviceType.CUDA

    runs = [(dt, dt, {}) for dt in ("int8", "int4")]
    runs.append((f"int8 varied sigma {SIGMA}", "int8",
                 dict(variation=Sampler(0), variation_std=SIGMA)))
    for dt, pack, kw in runs:
        packed = pack_model(params, cim.replace(pack_dtype=pack))
        for _ in range(2):                           # warm-up
            resnet.forward(packed, state, xb, dcfg, train=False, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.forwards):
                resnet.forward(packed, state, xb, dcfg, train=False, **kw)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / args.forwards
        kernels = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == cuda_type]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
            / args.forwards
        print(f"{dt}: batch {args.batch}, {args.forwards} forwards under the "
              f"profiler: wall {wall_ms:.3f} ms per forward", flush=True)
        if not kernels:
            print(f"{dt}: the profiler traced no device time: device busy "
                  "share not measured", flush=True)
            continue
        print(f"{dt}: device time {dev_ms:.3f} ms per forward, busy share "
              f"{dev_ms / wall_ms:.3f}, idle share {1 - dev_ms / wall_ms:.3f}",
              flush=True)
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        for e in kernels[:args.top]:
            ms = e.self_device_time_total / 1e3 / args.forwards
            print(f"  {ms:8.4f} ms/fwd {100 * ms / dev_ms:5.1f}%  "
                  f"{e.count // args.forwards:4d}x  {e.key[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
