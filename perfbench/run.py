#!/usr/bin/env python3
"""Run one benchmark cell once on this machine's card and print its result
as the last line of standard output (one JSON object).

    python3 perfbench/run.py --workload resnet18.eval --seed 7 \
        --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice of the window. The compared
numbers and their limits end standard error and the result line. Exits
non-zero, printing no result, without a CUDA card, when the cell asks
for more cards than there are, on any error, or when JAX or the JAX
package was imported.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # caches of the port's builds stay inside the checkout, at fixed paths
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench import harness

    b = harness.bench()
    chips = harness.workload(b, args.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s), {have} "
              "available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    ctx = harness.context(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", T_START)
    result, rows = harness.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
