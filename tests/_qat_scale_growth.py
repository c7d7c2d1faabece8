"""Run the JAX package's QAT harness and the port's ``train_qat`` on the
CPU at one setting and print, for each, the losses, the first non-finite
step and the largest LSQ weight scale ``s_w``: a witness of where the
harness's scales grow without bound.

    PYTHONPATH=src python3 tests/_qat_scale_growth.py [--steps 300]

The setting is ``chip_smoke.py`` phase 11's (the paper's CIFAR-10 CIM
config, ``make_image_dataset(n=4096, seed=0)``, batch 128, lr 0.05
cosine, seed 0) at the harness's own size, widths 8/16/32 at 16x16
(``benchmarks/common.py``): the harness runs unchanged, and the port's
harness at the same widths. Each run is deterministic on the CPU. Not
collected by pytest (a run takes minutes).
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

IMAGES, BATCH, LR = 4096, 128, 0.05


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _max_sw(params) -> float:
    return max(float(np.max(np.abs(np.asarray(v)))) for k, v in
               _leaves(params) if k.endswith("/s_w"))


def _report(tag, losses, sw, seconds) -> None:
    """``sw``: {step: max |s_w| after it}, step 0 the calibrated start."""
    losses = np.asarray(losses)
    bad = np.where(~np.isfinite(losses))[0]
    print(f"{tag}: {seconds:.0f} s; loss first 20 {losses[:20].mean():.4f}, "
          f"last 20 {losses[-20:].mean():.4f}; first non-finite loss at step "
          f"{int(bad[0]) if len(bad) else None}; max |s_w| "
          + ", ".join(f"after step {k} {v:.4g}" for k, v in sorted(sw.items())),
          flush=True)


def run_jax(steps: int) -> None:
    import jax
    from benchmarks import common as jqat
    from repro.models.resnet import calibrate, init
    cim = jqat.make_cim("column", "column")
    data = jqat._data(0, n=IMAGES)
    cfg = jqat.resnet_cfg(cim)
    params, state = init(jax.random.PRNGKey(0), cfg)
    params = calibrate(params, state, data[0][0][:128], cfg)
    t0 = time.perf_counter()
    out = jqat.train_qat(cim, steps=steps, batch=BATCH, lr=LR, seed=0,
                         data=data)
    _report("JAX harness (benchmarks/common.py)", out["losses"],
            {0: _max_sw(params), steps: _max_sw(out["params"])},
            time.perf_counter() - t0)


def run_port(steps: int) -> None:
    from repro_torch.train import qat
    sw = {}

    def on_step(it, params, state, mom):
        if it + 1 in (1, 25, 50, 100, steps):
            sw[it + 1] = _max_sw(params)
    t0 = time.perf_counter()
    out = qat.train_qat(qat.make_cim("column", "column"), steps=steps,
                        batch=BATCH, lr=LR, seed=0,
                        data=qat._data(0, n=IMAGES, hw=qat.HW),
                        device="cpu", on_step=on_step)
    _report("port (repro_torch.train.qat)", out["losses"], sw,
            time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--package", choices=("jax", "port", "both"),
                    default="both")
    args = ap.parse_args()
    if args.package in ("jax", "both"):
        run_jax(args.steps)
    if args.package in ("port", "both"):
        run_port(args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
