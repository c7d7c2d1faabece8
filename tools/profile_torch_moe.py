#!/usr/bin/env python3
"""Where the time of the port's transformer serving goes, on a card.

Builds a serving path of ``chip_smoke.py``: by default phase 10's MoE
transformer (moonshot-v1-16b-a3b at its published widths, depth cut to 4
layers), or with ``--arch`` a zoo entry of phase 13 with its cut
(deepseek-v3-671b, llama3-8b, qwen3-0.6b; ``--kv-cache-dtype int8`` for
the int8 KV cache); the serving launcher's CIM config, bfloat16, int8
planes. Then profiles one prefill (batch x prompt tokens through the
cache) and a run of decode steps under ``torch.profiler``. Prints, for
each: the wall time per step, the device's busy share (summed kernel and
copy time over wall time), the number of device kernels launched per
step, and the kernels that take the most device time.

    python3 tools/profile_torch_moe.py [--arch llama3-8b] [--batch 8]
        [--prompt 64] [--steps 8] [--kv-cache-dtype bf16|int8]

Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _report(prof, what: str, wall_ms: float, steps: int, top: int,
            cuda_type) -> None:
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda_type]
    print(f"{what}: wall {wall_ms:.3f} ms per step", flush=True)
    if not kernels:
        print(f"{what}: the profiler traced no device time: device busy "
              "share not measured", flush=True)
        return
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    n = sum(e.count for e in kernels) // steps
    print(f"{what}: device time {dev_ms:.3f} ms per step, busy share "
          f"{dev_ms / wall_ms:.3f}, idle share {1 - dev_ms / wall_ms:.3f}; "
          f"{n} device kernels per step", flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"  {ms:8.4f} ms/step {100 * ms / dev_ms:5.1f}%  "
              f"{e.count // steps:4d}x  {e.key[:110]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--kv-cache-dtype", default="bf16")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_moe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MOE_ARCH, ZOO_CASES, moe_config, zoo_config
    from repro_torch.api import model_artifact
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)

    if args.arch == MOE_ARCH:
        cfg = moe_config()["cfg"]
    else:
        cuts = {arch: cut for _, arch, cut, _, _ in ZOO_CASES}
        if args.arch not in cuts:
            ap.error(f"--arch: one of {[MOE_ARCH, *cuts]}")
        cfg = zoo_config(args.arch, cuts[args.arch])["cfg"]
    cfg = cfg.replace(kv_cache_dtype=args.kv_cache_dtype)
    print(f"model: {cfg.name}, {cfg.n_layers} layers, KV cache "
          f"{cfg.kv_cache_dtype}", flush=True)
    model = get_model(cfg)
    art = model_artifact(init_params(model.specs(cfg), 0), cfg.cim)
    params, dcfg = art.params, cfg.replace(cim=art.config)
    max_len = args.prompt + 2 * (args.steps + 2) + 1
    g = torch.Generator().manual_seed(10)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                           generator=g).cuda()
    cuda_type = torch.autograd.DeviceType.CUDA
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def prefill():
        cache = model.init_cache(cfg, args.batch, max_len)
        logits, cache = model.decode_step(params, cache, tokens, dcfg)
        return cache, torch.argmax(logits[:, -1:].float(), -1).to(torch.int32)

    prefill()                                     # warm-up
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cache, tok = prefill()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    _report(prof, f"prefill {args.batch} x {args.prompt}", wall, 1, args.top,
            cuda_type)

    for _ in range(2):                            # warm-up
        logits, cache = model.decode_step(params, cache, tok, dcfg)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            logits, cache = model.decode_step(params, cache, tok, dcfg)
            tok = torch.argmax(logits[:, -1:].float(), -1).to(torch.int32)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / args.steps
    _report(prof, f"decode batch {args.batch}", wall, args.steps, args.top,
            cuda_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
