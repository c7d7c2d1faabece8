#!/usr/bin/env python3
"""Dry-run records of the serve cells whose decode caches split over
``"model"``, for the checkout whose ``src`` is on ``PYTHONPATH`` (a parent
in ``build/`` beside the change, one process each):

    PYTHONPATH=src python3 tools/dry_cells.py --out build/dry_cells.json

For each cell of ``CELLS`` on the (16, 16) mesh: ``launch.dryrun.run_cell``
(rank 0's step counted on ``meta`` under the fake process group: FLOPs,
op bytes, the live-storage peak, collective bytes by kind) and the bytes
rank 0 holds of each decode-cache leaf name, as ``init_cache`` lays the
cache out under the cell's session mesh (``launch.dryrun.rank_cell``).
Runs on the host alone; no card is needed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

#: (arch, shape, config overrides)
CELLS = (
    ("deepseek-v3-671b", "decode_32k", {"flash_decode": True}),
    ("deepseek-v3-671b", "decode_32k", {}),
    ("zamba2-2.7b", "decode_32k", {}),
)


def cache_bytes(arch, shape, mesh, overrides):
    """{leaf name: bytes rank 0 holds of it, summed over the cache}."""
    from repro_torch.core import colshard
    from repro_torch.launch import dryrun
    out = {}
    with dryrun.rank_cell(arch, shape, mesh,
                          overrides=overrides or None) as (_, args):
        def walk(tree, name=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, k)
            elif isinstance(tree, (list, tuple)):
                for v in tree:
                    walk(v, name)
            else:
                loc = colshard.local(tree)
                out[name] = (out.get(name, 0)
                             + loc.numel() * loc.element_size())
        walk(args[1])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import parse_mesh
    mesh = parse_mesh(args.mesh)
    recs = []
    for arch, shape, ov in CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh=mesh, overrides=ov or None,
                              verbose=False)
        rec["overrides"] = ov
        rec["cache_bytes"] = cache_bytes(arch, shape, mesh, ov)
        rec["wall_s"] = round(time.perf_counter() - t0, 1)
        pd = rec["per_device"]
        print(f"[dry_cells] {arch} {shape} {ov}: collective "
              f"{pd['collective_bytes']} B {rec['collectives']}, peak "
              f"{pd['bytes_per_device_peak']} B, FLOPs {pd['hlo_flops']}, "
              f"cache bytes a rank {rec['cache_bytes']} "
              f"({rec['wall_s']} s)", flush=True)
        recs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
