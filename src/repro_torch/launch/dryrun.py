"""Dry run of the port (counterpart of ``repro.launch.dryrun``): one rank's
step of an (arch x shape x mesh) cell run on the cell's ``meta`` argument
records, counted op by op, and the three roofline terms of one NVIDIA H100.

  PYTHONPATH=src python -m repro_torch.launch.dryrun \
      --arch llama3-8b --shape train_4k --mesh 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 2x2 \
      --out build/dryrun.json

Torch has no ahead-of-time lowering, so nothing is compiled: the cell's
step runs eagerly on ``meta`` tensors (shapes and dtypes, no data, no
device), as rank 0 of the mesh under PyTorch's fake process group
(``launch.mesh.dry_mesh``: collectives return at once and move nothing).
What the reference reads from the compiled program is counted on the
ops as they run:

- FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (its total), split
  by the dtype of each counted op's first operand (the same formulas,
  ``flop_registry``);
- bytes as the sum of each op's tensor inputs and outputs, views not
  counted: it stands in for XLA's "bytes accessed";
- the peak as the most bytes of ``meta`` storages alive at once, the
  arguments included, tracked as ops make them and Python frees them: it
  stands in for ``memory_analysis``;
- argument bytes a rank from the cell's placements (each leaf's block);
- collective bytes by kind from ``core.colshard.collective`` (each op's
  output bytes, as the reference sums them from the HLO).

The record keeps the reference's keys (``per_device``, ``collectives``,
``roofline``); ``count_s`` takes the place of ``lower_s`` and
``compile_s``. Eager counts include every loop the step runs (chunked
attention, SSD and mLSTM chunks, the sLSTM token loop, microbatches), so
no loop correction is needed; their cost is the time the step takes on
``meta``, which grows with depth (``launch.account`` counts at a few
depths and solves for the cell's).

Roofline terms, from NVIDIA's H100 SXM data sheet (dense rates, at the
700 W limit):
  compute    = sum over dtypes of FLOPs / peak: bfloat16 989e12 FLOP/s,
               float32 67e12 (TF32 off, as the port runs), int8 1.979e15
               ops/s, float64 67e12 (its tensor cores)
  memory     = bytes / 3.35e12 B/s (HBM3)
  collective = collective bytes / 900e9 B/s (NVLink 4, aggregate a card)
The fit bound is the card's 80e9 bytes. The CIM configs are built with
``use_kernel=False``, as the reference's: the count is of the plain path,
whose shapes the kernels share.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import tree_leaves

from .mesh import MeshShape, dry_mesh, parse_mesh

#: peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 67e12, "int8": 1.979e15, "uint8": 1.979e15}
HBM_BW = 3.35e12               # B/s, HBM3
LINK_BW = 900e9                # B/s, NVLink 4 aggregate
FIT_BYTES = 80e9               # the card's memory

def one_device() -> MeshShape:
    return MeshShape((1, 1), ("data", "model"))


def mesh_label(mesh: MeshShape) -> str:
    return "x".join(str(d) for d in mesh.shape)


# ---------------------------------------------------------------------------
# model-FLOPs estimates (6*N_active*D) for the usefulness ratio
# ---------------------------------------------------------------------------

def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def param_counts(cell) -> Dict[str, int]:
    """{"total", "active"} parameters of the cell's model: a routed
    expert bank counts top_k / n_experts of its parameters as active."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import eval_shape_params
    struct = eval_shape_params(get_model(cell.cfg).specs(cell.cfg))
    leaves = {"/".join(map(str, p)): l for p, l in _walk(struct)}
    total = sum(math.prod(l.shape) for l in leaves.values())
    active = 0
    moe = cell.cfg.moe
    for path, l in leaves.items():
        n = math.prod(l.shape)
        is_expert = (moe is not None and "/moe/" in "/" + path + "/"
                     and path.rsplit("/", 1)[-1] in ("wg", "wu", "wd")
                     and len(l.shape) >= 3 and l.shape[-3] == moe.n_experts)
        active += n * moe.top_k // moe.n_experts if is_expert else n
    return {"total": total, "active": active}


def model_flops(cell) -> float:
    """6 * N_active * tokens (train) / 2 * N_active * tokens (inference)."""
    n = param_counts(cell)["active"]
    sh = cell.shape
    if cell.kind == "train":
        return 6.0 * n * sh.global_batch * sh.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * sh.global_batch * sh.seq_len
    return 2.0 * n * sh.global_batch


# ---------------------------------------------------------------------------
# counting one step on meta tensors
# ---------------------------------------------------------------------------

def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _local(x: torch.Tensor) -> torch.Tensor:
    from repro_torch.core import colshard
    return colshard.local(x)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _held(tree):
    """The tensors of a tree as a rank holds them (a placed leaf's
    block)."""
    return [_local(x) for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree as a rank holds them."""
    return sum(_nbytes(x) for x in _held(tree))


class _Tally(TorchDispatchMode):
    """Per op: FLOPs by dtype (``flop_registry``), bytes of its tensor
    inputs and outputs (not for views), and the bytes of live storages
    (each new storage added as an op makes it, dropped when Python frees
    it; views share their base's)."""

    def __init__(self, held):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops: Dict[str, int] = {}
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._ids: set = set()
        for x in held:
            self._track(x)
        self.peak = self.live

    def _free(self, key, n):
        self._ids.discard(key)
        self.live -= n

    def _track(self, x: torch.Tensor) -> None:
        st = x.untyped_storage()
        key = id(st)
        if key in self._ids:
            return
        n = st.nbytes()
        self._ids.add(key)
        self.live += n
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            first = next(x for x in _tensors((args, kwargs)))
            key = str(first.dtype).replace("torch.", "")
            self.flops[key] = self.flops.get(key, 0) + int(
                self.registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if not getattr(func, "is_view", False):
            self.ops += 1
            self.bytes += sum(_nbytes(x) for x in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(x) for x in outs)
        for x in outs:
            self._track(x)
        self.peak = max(self.peak, self.live)
        return out


def count_step(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` on ``meta`` tensors and count it: FLOPs
    (``FlopCounterMode``'s total and the split by dtype), bytes, ops, the
    peak of live bytes (the arguments included), argument and output
    bytes, output bytes that alias an argument, collective bytes by kind
    and ops by kind and mesh dim (``core.colshard.collective``), and the
    wall seconds of the count."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import colshard
    held = _held(args)
    arg_ids = {id(x.untyped_storage()) for x in held}
    colshard.reset_collective_counts()
    t0 = time.perf_counter()
    tally = _Tally(held)
    counter = FlopCounterMode(display=False)
    with tally, counter:
        out = fn(*args)
    count_s = time.perf_counter() - t0
    outs = _held(out)
    alias = sum(_nbytes(x) for x in outs
                if id(x.untyped_storage()) in arg_ids)
    rec = {"flops": int(counter.get_total_flops()),
           "flops_by_dtype": dict(tally.flops), "bytes": tally.bytes,
           "ops": tally.ops, "peak": tally.peak,
           "argument": sum(_nbytes(x) for x in held),
           "output": sum(_nbytes(x) for x in outs), "alias": alias,
           "collectives": dict(colshard.collective.bytes),
           "collective_ops": sum(colshard.collective.ops.values()),
           "collective_axes": {k: dict(v) for k, v in
                               colshard.collective.axes.items() if v},
           "count_s": count_s}
    del out, outs
    return rec


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Sum over dtypes of FLOPs over the card's peak for that dtype (any
    other dtype at float32's)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
               for dt, f in flops_by_dtype.items())


def roofline(flops_by_dtype, nbytes, coll_bytes) -> Dict[str, Any]:
    terms = {"compute_s": compute_seconds(flops_by_dtype),
             "memory_s": nbytes / HBM_BW,
             "collective_s": coll_bytes / LINK_BW}
    return {**terms, "dominant": max(terms, key=terms.get)}


def block_shape(shape, placements, mesh) -> tuple:
    """A leaf's block on a rank under ``placements`` on ``mesh`` (a
    ``DeviceMesh`` or ``MeshShape``): each split dim over the product of
    the ranks of the mesh dims splitting it (the reference's
    ``NamedSharding.shard_shape``; ``build_cell`` keeps only splits that
    divide)."""
    from torch.distributed.tensor import Shard

    from repro_torch.nn.module import mesh_sizes
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for name, p in zip(tuple(mesh.mesh_dim_names), placements or ()):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // sizes[name])
    return tuple(out)


def argument_bytes(cell, index: Optional[int] = None) -> int:
    """Bytes of every argument a rank holds (of the step's argument
    ``index`` alone when given), from the cell's placements."""
    from repro_torch.nn.module import is_placements

    def walk(struct, pl):
        if isinstance(struct, dict):
            return sum(walk(v, None if pl is None else pl[k])
                       for k, v in struct.items())
        if isinstance(struct, (list, tuple)):
            return sum(walk(v, None if pl is None else pl[i])
                       for i, v in enumerate(struct))
        if not isinstance(struct, torch.Tensor):
            return 0
        if pl is not None and not is_placements(pl):
            raise ValueError(f"placements {pl!r} do not match a leaf")
        return math.prod(block_shape(tuple(struct.shape), pl, cell.mesh)) \
            * struct.element_size()
    pairs = list(zip(cell.arg_structs, cell.in_shardings))
    if index is not None:
        pairs = pairs[index:index + 1]
    return sum(walk(s, p) for s, p in pairs)


def cim_config(cim, pack: str = "int8"):
    """The reference dry run's CIM config for ``cim`` ("emulate" or
    "deploy"; None or "off": none) with its planes packed as ``pack`` (the
    perf experiments' int8 or int4), or ``cim`` itself when it is one."""
    if cim is None or cim == "off":
        return None
    if not isinstance(cim, str):
        return cim
    from repro_torch.core.cim_linear import CIMConfig
    from repro_torch.core.granularity import Granularity
    return CIMConfig(
        enabled=True, mode=cim, weight_bits=4, cell_bits=2, act_bits=8,
        psum_bits=6, array_rows=256, array_cols=256,
        weight_granularity=Granularity.COLUMN,
        psum_granularity=Granularity.COLUMN, use_kernel=False,
        pack_dtype=pack)


@contextlib.contextmanager
def rank_cell(arch: str, shape, mesh: MeshShape, **kw):
    """(cell, args): the cell built on rank 0 of ``mesh`` and its
    arguments as that rank's step takes them, with the fake group joined
    and the cell's mesh installed as the session mesh while inside: the
    params (and a train step's optimizer state) as ``meta`` blocks under
    the cell's placements; a serve step's decode cache as the port's
    ``init_cache`` lays it out under that session mesh, as the cell's
    placements say (every leaf's rows over the batch axes where their
    ranks divide the batch; the time of K/V and of MLA's latent cache and
    the SSD state's heads over ``"model"`` where its ranks divide them);
    the batch or tokens whole: a data parallel train or serve step takes
    the global batch and reads its rows (``launch.cells.serve_rows``), so
    a serve cell counts one rank's rows, as the reference's GSPMD step
    runs them. On one device no group is joined and nothing is placed."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.module import place_tree, session_mesh

    from repro_torch.configs.registry import get_config

    from .cells import build_cell
    if math.prod(mesh.shape) == 1:
        cell = build_cell(arch, shape, mesh, **kw)
        yield cell, cell.arg_structs
        return
    ov = dict(kw.pop("overrides", None) or {})
    if get_config(arch).moe is not None:
        # expert banks placed over "model" run on the expert-parallel path
        # alone: the port has no counterpart of GSPMD's auto-partitioned
        # jit dispatch
        ov.setdefault("moe_impl", "auto")
    kw["overrides"] = ov or None
    with dry_mesh(mesh) as dm:
        cell = build_cell(arch, shape, dm, **kw)
        params, second, batch = cell.arg_structs
        params = place_tree(params, cell.in_shardings[0], dm)
        with session_mesh(dm, cell.rules):
            if cell.kind == "train":
                second = place_tree(second, cell.in_shardings[1], dm)
            else:
                second = get_model(cell.cfg).init_cache(
                    cell.cfg, cell.shape.global_batch, cell.shape.seq_len,
                    device="meta")
            yield cell, (params, second, batch)


def count_cell(arch: str, shape, mesh: MeshShape, **kw) -> Dict[str, Any]:
    """``count_step`` of rank 0's step of the cell, with the argument bytes
    from its placements and the cell's kind."""
    with rank_cell(arch, shape, mesh, **kw) as (cell, args):
        rec = count_step(cell.step_fn, args)
        rec["argument_placed"] = argument_bytes(cell)
        rec["kind"] = cell.kind
        rec["model_flops"] = model_flops(cell)
    return rec


# ---------------------------------------------------------------------------
# per-cell dry run
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name, *, mesh: Optional[MeshShape] = None,
             cim=None, verbose: bool = True,
             overrides: Optional[Dict[str, Any]] = None,
             accum: Optional[int] = None,
             run_overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """The dry-run record of one cell on ``mesh`` (one device when None):
    rank 0's step counted on ``meta`` tensors under the fake group."""
    from repro_torch.configs.registry import cell_status
    mesh = mesh or one_device()
    name = shape_name if isinstance(shape_name, str) else shape_name.name
    chips = math.prod(mesh.shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": name,
                           "mesh": mesh_label(mesh),
                           "multi_pod": "pod" in mesh.mesh_dim_names,
                           "cim": (cim if isinstance(cim, str) else
                                   getattr(cim, "mode", None)) or "off"}
    ok, why = cell_status(arch, name)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        if verbose:
            print(f"[dryrun] {arch} x {name}: SKIP ({why})")
        return rec
    c = count_cell(arch, shape_name, mesh, cim=cim_config(cim),
                   overrides=overrides, accum=accum,
                   run_overrides=run_overrides)
    coll = sum(c["collectives"].values())
    rf = roofline(c["flops_by_dtype"], c["bytes"], coll)
    rec.update({
        "status": "ok",
        "chips": chips,
        "kind": c["kind"],
        "count_s": round(c["count_s"], 1),
        "per_device": {
            "hlo_flops": c["flops"],
            "flops_by_dtype": c["flops_by_dtype"],
            "hlo_bytes": c["bytes"],
            "collective_bytes": coll,
            "collective_ops": c["collective_ops"],
            "bytes_per_device_argument": c["argument_placed"],
            "bytes_per_device_output": c["output"],
            "bytes_per_device_temp": max(0, c["peak"] - c["argument"]),
            "bytes_per_device_alias": c["alias"],
            "bytes_per_device_peak": c["peak"],
        },
        "collectives": c["collectives"],
        "roofline": {
            **rf,
            "model_flops_global": c["model_flops"],
            "useful_ratio": (c["model_flops"] / chips) / max(c["flops"], 1),
            "fit_bound_gb": FIT_BYTES / 1e9,
        },
    })
    if verbose:
        pd, r = rec["per_device"], rec["roofline"]
        print(f"[dryrun] {arch} x {name} ({rec['mesh']}, cim={rec['cim']}): "
              f"OK  kind={c['kind']}")
        print(f"  count {c['count_s']:.1f}s | per-dev FLOPs "
              f"{pd['hlo_flops']:.3e} bytes {pd['hlo_bytes']:.3e} coll "
              f"{coll:.3e} ({pd['collective_ops']} ops)")
        print(f"  memory/device: args "
              f"{pd['bytes_per_device_argument'] / 1e9:.2f}GB out "
              f"{pd['bytes_per_device_output'] / 1e9:.2f}GB temp "
              f"{pd['bytes_per_device_temp'] / 1e9:.2f}GB peak "
              f"{pd['bytes_per_device_peak'] / 1e9:.2f}GB")
        print(f"  roofline: compute {r['compute_s']:.3e}s memory "
              f"{r['memory_s']:.3e}s collective {r['collective_s']:.3e}s "
              f"-> dominant={r['dominant']} useful={r['useful_ratio']:.2f}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="16x16",
                    help="16x16, 2x16x16, 2x2, 1 (ranks of (pod,) data, "
                         "model)")
    ap.add_argument("--cim", default="off",
                    choices=["off", "emulate", "deploy"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    mesh = parse_mesh(args.mesh)
    results, failures = [], 0
    for arch, shape in cells:
        try:
            results.append(run_cell(arch, shape, mesh=mesh, cim=args.cim))
        except Exception as e:
            failures += 1
            traceback.print_exc()
            results.append({"arch": arch, "shape": shape,
                            "mesh": mesh_label(mesh), "status": "error",
                            "error": f"{type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {len(results)} records to {args.out}")
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    print(f"[dryrun] ok={n_ok} skipped={n_skip} failed={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
