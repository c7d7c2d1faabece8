#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card:
for each seed one run of the cell with a short window and its compared
numbers, and on the first ``--control-seeds`` seeds the control's too
(the reference computed one precision lower, in the program's place).
All seeds run in one process. Not run by the benchmark's own runs.

    python3 perfbench/readings.py --workload resnet18.eval --seeds 101-112 \\
        --control-seeds 3 --seconds 2 [--out readings.jsonl]
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def seeds(spec: str):
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first-last")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for k, seed in enumerate(seeds(args.seeds)):
        t = time.perf_counter()
        ctx = harness.context(args.workload, seed, args.seconds, False,
                              "cuda:0", t)
        driver = importlib.import_module(
            f"perfbench.drivers.{ctx.traffic['kind']}")
        out = driver.run(ctx)
        check = out.pop("check")
        row = {"seed": seed, "setup_s": ctx.window_t0 - t,
               **out["end_to_end"],
               "memory_peak_bytes": out["memory_peak_bytes"]}
        del out
        torch.cuda.empty_cache()
        t = time.perf_counter()
        kw = {"control": k < args.control_seeds}
        if ctx.traffic["kind"] == "qat":
            kw["faults"] = kw["control"]
        row.update(check(**kw))
        row["check_s"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.reset_peak_memory_stats()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    for key in sorted({k for r in rows for k in r} - {"seed"}):
        vals = [r[key] for r in rows if key in r]
        print(f"{key}: min {min(vals)!r} max {max(vals)!r} over "
              f"{len(vals)} seeds", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
