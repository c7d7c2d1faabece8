"""Perf experiments over the port's accounting (counterpart of
``repro.launch.perf``).

Each experiment is a named variant of a cell (config, run or CIM
overrides). Each is counted with ``launch.account`` (one rank's
step on ``meta`` tensors under the fake process group, solved for the
cell's depth) and writes the three roofline terms of one H100, the
collective bytes by kind and the peak estimate as JSON records:

  PYTHONPATH=src python -m repro_torch.launch.perf --cell moe_train \
      --out build/perf_moe_train.json

Every knob of the reference's variants has a counterpart in the port:
``moe_impl="auto"`` (the expert-parallel MoE), ``fsdp``/``zero1`` run
overrides, accumulation, ``flash_decode`` (the time-sharded cache),
CIM deploy at int8 and int4, ``kv_cache_dtype="int8"`` and the attention
chunk. The reference's ``moe_train`` also has ``baseline_autospmd``
(GSPMD's auto-partitioned dispatch), which has no counterpart: the port
runs expert banks placed over the mesh on the expert-parallel path
alone, so that variant would count the same step as ``ep_shardmap``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

from .dryrun import FIT_BYTES, cim_config, model_flops, roofline
from .mesh import parse_mesh

# experiment registry: cell -> [(variant_name, kwargs for account_cell)];
# a variant's ``"cim": {"pack": ...}`` is the dry run's deploy config
# (``dryrun.cim_config``) packed so, built when the variant runs
EXPERIMENTS = {
    # MoE training: the expert-parallel dispatch, ZeRO-1 in place of FSDP,
    # and accumulation
    "moe_train": {
        "arch": "moonshot-v1-16b-a3b", "shape": "train_4k",
        "variants": [
            ("ep_shardmap", {"overrides": {"moe_impl": "auto"}}),
            ("ep_zero1", {"overrides": {"moe_impl": "auto"},
                          "run_overrides": {"fsdp": False, "zero1": True}}),
            ("ep_zero1_accum4", {"overrides": {"moe_impl": "auto"},
                                 "run_overrides": {"fsdp": False,
                                                   "zero1": True},
                                 "accum": 4}),
        ],
    },
    # the paper-representative cell: quantized-weight decode; flash decode
    # time-shards the cache, then the column-quantized int weights and the
    # int8 KV cache attack the memory term
    "decode_quant": {
        "arch": "llama3-8b", "shape": "decode_32k",
        "variants": [
            ("baseline_bf16", {}),
            ("flash_decode", {"overrides": {"flash_decode": True}}),
            ("flash_cim_int8", {"overrides": {"flash_decode": True},
                                "cim": {"pack": "int8"}}),
            ("flash_cim_int4", {"overrides": {"flash_decode": True},
                                "cim": {"pack": "int4"}}),
            ("flash_kv8", {"overrides": {"flash_decode": True,
                                         "kv_cache_dtype": "int8"}}),
            ("flash_kv8_cim_int4", {"overrides": {"flash_decode": True,
                                                  "kv_cache_dtype": "int8"},
                                    "cim": {"pack": "int4"}}),
        ],
    },
    # 32k prefill: the flash chunk trades recompute against score traffic
    "prefill": {
        "arch": "llama3-8b", "shape": "prefill_32k",
        "variants": [
            ("baseline_chunk2048", {}),
            ("chunk4096", {"overrides": {"attn_chunk": 4096}}),
            ("chunk8192", {"overrides": {"attn_chunk": 8192}}),
            ("chunk4096_cim_int4", {"overrides": {"attn_chunk": 4096},
                                    "cim": {"pack": "int4"}}),
        ],
    },
}


def measure(arch, shape, *, label, mesh, reduced=False, **kw):
    """The record of one variant (``kw``: ``overrides``, ``run_overrides``,
    ``accum``, ``cim``) of the cell ``arch`` x ``shape`` (a name of
    ``SHAPES`` or a ``Shape``) on ``mesh`` (a ``MeshShape``)."""
    from .account import account_cell
    from .cells import build_cell
    t0 = time.time()
    rec = {"label": label, "arch": arch,
           "shape": shape if isinstance(shape, str) else shape.name}
    kw = dict(kw)
    if isinstance(kw.get("cim"), dict):
        kw["cim"] = cim_config("deploy", **kw["cim"])
    try:
        acct = account_cell(arch, shape, mesh, verbose=False,
                            reduced=reduced, **kw)
        rec.update({k: acct[k] for k in ("hlo_flops", "hlo_bytes",
                                         "collective_bytes")})
        rec["collectives"] = acct["collectives"]
        rec["peak_hbm_gb"] = acct["peak_bytes"] / 1e9
        rec["fit_bound_gb"] = FIT_BYTES / 1e9
        rec["roofline"] = roofline(acct["flops_by_dtype"], acct["hlo_bytes"],
                                   acct["collective_bytes"])
        cell = build_cell(arch, shape, mesh, reduced=reduced,
                          cim=kw.get("cim"), overrides=kw.get("overrides"),
                          run_overrides=kw.get("run_overrides"),
                          accum=kw.get("accum"))
        rec["useful_ratio"] = (model_flops(cell) / math.prod(mesh.shape)) \
            / max(acct["hlo_flops"], 1.0)
        rec["count_s"] = acct["count_s"]
        rec["status"] = "ok"
    except Exception as e:
        traceback.print_exc()
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
    rec["wall_s"] = round(time.time() - t0, 1)
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(f"[perf] {label}: c={r['compute_s']:.3e} m={r['memory_s']:.3e}"
              f" x={r['collective_s']:.3e} dom={r['dominant']}"
              f" hbm={rec['peak_hbm_gb']:.1f}GB useful="
              f"{rec['useful_ratio']:.2f} ({rec['wall_s']}s)", flush=True)
    else:
        print(f"[perf] {label}: ERROR {rec['error']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(EXPERIMENTS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    exp = EXPERIMENTS[args.cell]
    out = args.out or f"build/perf_{args.cell}.json"
    ledger = []
    if os.path.exists(out):
        with open(out) as f:
            ledger = json.load(f)
    done = {r["label"] for r in ledger if r.get("status") == "ok"}
    mesh = parse_mesh(args.mesh)
    for label, kw in exp["variants"]:
        if (args.variant and label != args.variant) or label in done:
            continue
        ledger.append(measure(exp["arch"], exp["shape"], label=label,
                              mesh=mesh, **kw))
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(ledger, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
