#!/usr/bin/env python3
"""Repeat ``chip_smoke.py`` phase 11's QAT run on a card and report, per
run, its losses and where it goes non-finite.

    python3 tools/repeat_qat.py [--default 3] [--deterministic 2]

The run is phase 11's own (``chip_smoke.qat_run``): ResNet-20 at full
width with the paper's CIFAR-10 settings,
``make_image_dataset(n=4096, hw=32, seed=0)``, 300 steps at batch 128,
lr 0.05 cosine, seed 0. ``--default`` runs take cuDNN's
default convolution algorithms, ``--deterministic`` runs its
deterministic ones. Per run: the first three losses, the mean loss of
the first and last 20 steps, the held-out accuracy and the first
non-finite step; for a run that goes non-finite, the first parameters to
do so and the largest magnitudes of the parameters over the steps before
it; else the parameters that end largest. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _leaves(tree, path=""):
    import torch
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif torch.is_tensor(tree):
        yield path, tree


def run(tag, cs, qat, data, dev, deterministic: bool) -> None:
    import torch
    names, amax = [], []

    def on_step(it, params, state, mom):
        leaves = list(_leaves(params))
        if not names:
            names.extend(n for n, _ in leaves)
        amax.append(torch.stack([
            p.detach().float().abs().amax() if p.numel()
            else p.new_zeros((), dtype=torch.float32) for _, p in leaves]))
    out, wall_s = cs.qat_run(torch, qat, data, dev, on_step, deterministic)
    losses = np.asarray(out["losses"])
    mags = torch.stack(amax).cpu().numpy()              # (steps, leaves)
    bad = np.where(~np.isfinite(losses))[0]
    print(f"{tag}: {wall_s:.1f} s; losses[0:3] "
          f"{losses[:3]}, first 20 {losses[:20].mean():.6f}, last 20 "
          f"{losses[-20:].mean():.6f}, held-out accuracy {out['acc']:.4f}, "
          f"first non-finite loss at step "
          f"{int(bad[0]) if len(bad) else None}", flush=True)
    finite = np.isfinite(mags)
    if finite.all():
        top = np.argsort(-mags[-1])[:4]
        print("  largest parameters at the end: " + ", ".join(
            f"{names[j]} {mags[-1, j]:.3g}" for j in top), flush=True)
        return
    s0 = int(np.where(~finite.all(axis=1))[0][0])
    print(f"  first non-finite parameters at step {s0}: "
          f"{[names[j] for j in np.where(~finite[s0])[0]][:8]}", flush=True)
    lo = max(0, s0 - 6)
    ref = np.nan_to_num(mags[max(s0 - 1, 0)], nan=0.0, posinf=3e38)
    for j in np.argsort(-ref)[:4]:
        print(f"  {names[j]} max |p| at steps {lo}-{s0}: "
              f"{np.array2string(mags[lo:s0 + 1, j], precision=3)}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--default", type=int, default=3)
    ap.add_argument("--deterministic", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("repeat_qat: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.train import qat

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    data = qat._data(seed=0, n=cs.QAT_IMAGES, hw=32)
    dev = torch.device("cuda")
    for i in range(args.default):
        run(f"default algorithms, run {i}", cs, qat, data, dev, False)
    for i in range(args.deterministic):
        run(f"deterministic algorithms, run {i}", cs, qat, data, dev, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
