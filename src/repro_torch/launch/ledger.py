"""Roofline ledger of the port (counterpart of ``repro.launch.ledger``):
for every (arch x shape) cell of the registry, one rank's step on one
mesh counted by ``launch.account`` (the layer points on ``meta`` tensors
under the fake process group, solved for the cell's depth), the argument
bytes a rank from the cell's placements, and the three roofline terms of
one H100. Incremental JSON keyed ``arch|shape`` (resumable):

  PYTHONPATH=src python -m repro_torch.launch.ledger --mesh 16x16 \
      --out build/ledger.json

Skips come from ``configs.registry.cell_status``. The fit is written as a
bound read from the record (``fit_bound_gb``, the card's 80 GB), beside
the peak the account solves for (an estimate: live bytes are close to
affine in depth, not exactly). The reference's second mesh (its
multi-pod compile proof) has no counterpart: ``--mesh 2x16x16`` counts
that mesh instead.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from .dryrun import FIT_BYTES, argument_bytes, model_flops, roofline
from .mesh import parse_mesh


def load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save(path, ledger):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(ledger, f, indent=1)


def ledger_record(arch: str, shape: str, mesh) -> dict:
    """The ledger's record of one runnable cell on ``mesh`` (a
    ``MeshShape``)."""
    import math

    from .account import account_cell
    from .cells import build_cell
    t0 = time.time()
    acct = account_cell(arch, shape, mesh, verbose=False)
    cell = build_cell(arch, shape, mesh)
    chips = math.prod(mesh.shape)
    mf = model_flops(cell)
    peak = acct["peak_bytes"]
    rec = {"status": "ok", "mesh": "x".join(map(str, mesh.shape))}
    rec["production"] = {
        "kind": cell.kind, "chips": chips, "count_s": acct["count_s"],
        "per_device": {
            "hlo_flops": acct["hlo_flops"], "hlo_bytes": acct["hlo_bytes"],
            "collective_bytes": acct["collective_bytes"],
            "collective_ops": acct["collective_ops"],
            "flops_by_dtype": acct["flops_by_dtype"],
            "bytes_per_device_argument": argument_bytes(cell),
            "bytes_per_device_peak": peak},
        "collectives": acct["collectives"]}
    rec["account"] = {k: acct[k] for k in
                      ("hlo_flops", "hlo_bytes", "collective_bytes")}
    rf = roofline(acct["flops_by_dtype"], acct["hlo_bytes"],
                  acct["collective_bytes"])
    rec["roofline"] = {
        **rf,
        "model_flops_global": mf,
        "useful_ratio": (mf / chips) / max(acct["hlo_flops"], 1.0),
        "peak_hbm_gb": peak / 1e9,
        "fit_bound_gb": FIT_BYTES / 1e9,
        "source": "account"}
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/ledger.json")
    ap.add_argument("--only", default=None,
                    help="comma-separated arch filter")
    ap.add_argument("--mesh", default="16x16",
                    help="16x16, 2x16x16, 2x2, 1")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import all_cells

    mesh = parse_mesh(args.mesh)
    ledger = load(args.out)
    only = set(args.only.split(",")) if args.only else None
    t_all = time.time()
    for arch, shape, ok, why in all_cells():
        if only is not None and arch not in only:
            continue
        key = f"{arch}|{shape}"
        if key in ledger and ledger[key].get("status") in ("ok", "skipped"):
            continue
        if not ok:
            ledger[key] = {"status": "skipped", "reason": why}
            _save(args.out, ledger)
            print(f"[ledger] {key}: SKIP ({why})", flush=True)
            continue
        try:
            rec = ledger_record(arch, shape, mesh)
        except Exception as e:
            traceback.print_exc()
            rec = {"status": "error", "error": f"{type(e).__name__}: {e}"}
        ledger[key] = rec
        _save(args.out, ledger)
        if rec["status"] != "ok":
            continue
        r = rec["roofline"]
        print(f"[ledger] {key}: c={r['compute_s']:.2e}s "
              f"m={r['memory_s']:.2e}s x={r['collective_s']:.2e}s "
              f"dom={r['dominant'][:-2]} useful={r['useful_ratio']:.2f} "
              f"hbm={r['peak_hbm_gb']:.1f}GB count "
              f"{rec['production']['count_s']}s ({rec['wall_s']}s)",
              flush=True)

    n_ok = sum(1 for v in ledger.values() if v.get("status") == "ok")
    n_skip = sum(1 for v in ledger.values() if v.get("status") == "skipped")
    n_err = sum(1 for v in ledger.values() if v.get("status") == "error")
    print(f"[ledger] done in {time.time() - t_all:.1f} s: ok={n_ok} "
          f"skipped={n_skip} error={n_err}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
