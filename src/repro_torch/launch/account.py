"""Exact roofline accounting of a cell from a few small counts
(counterpart of ``repro.launch.account``).

The dry run (``launch.dryrun``) counts a step eagerly on ``meta`` tensors:
every loop body is counted as often as it runs, so nothing undercounts
and the reference's chunk-scan halving (``_chunk_knobs``) has no
counterpart. What an eager count costs is its time, which grows with the
depth. So the cell is counted at the reference's layer points, halved
(``_layer_plan``: two small depths, or three where two kinds of layer
stack) and the cell's depth is solved for exactly: counts are additive in
layers, so M = a + sum_i b_i L_i holds at every depth, and the solve is
made in rationals (``fractions.Fraction``), so a count that is linear is
extrapolated without rounding.

- **Gradient accumulation** A > 1: each point is counted at accum 1 and
  accum 2 and extrapolated as the reference does, M(A) = M(1) + (A - 1) *
  (M(2) - M(1)): work that depends only on the tokens cancels in the
  delta, and the per-microbatch costs (FSDP's weight gathers, the
  gradient sums) scale.
- **xlstm's sLSTM token loop** runs once per token, and a train or
  prefill count at 4096 or 32768 tokens would take minutes. The loop is
  counted at a short length and scaled by T (``_xlstm_plan``): blocks are
  counted by kind, the sLSTM alone at 16 and 32 tokens, the mLSTM alone
  at one and two of its chunks, and the solve is affine in T for each
  kind. This replaces the reference's analytic sLSTM term
  (``_slstm_flops``), which covered what its loop-body count missed.

Every count field is solved the same way: FLOPs (and by dtype), bytes,
collective bytes and ops by kind. The peak is solved too, as an
estimate: live bytes are close to affine in depth under remat, not
exactly (xlstm's as if every block were an mLSTM block), and under
accumulation a microbatch's activations shrink as 1/A
(from the accum 1 and 2 counts) rather than growing with A.

What is exact, and tested: FLOPs at every depth, accumulation and
length; bytes and collectives in depth, each layer's ops not depending on
the depth (every stack takes its layers through one ``unbind`` per leaf,
``models.transformer._layers``, so its backward stacks the layers'
gradients once: the transformer's, whisper's, xlstm's and zamba2's);
a serve cell's counts are one rank's rows (``launch.cells.serve_rows``).
The bytes under accumulation are an estimate (the accum 1 step skips the
float32 gradient sums the accum 2 step makes).
"""
from __future__ import annotations

import dataclasses
import time
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config

from .dryrun import count_cell

_FIELDS = ("flops", "bytes", "peak")


def _layer_plan(cfg) -> Tuple[List[Tuple[Dict, Tuple[int, ...]]],
                             Tuple[int, ...]]:
    """[(overrides, layer vector)] points and the layer vector of ``cfg``:
    the reference's plan on the config, at half its depths where a stack
    is uniform (one and two layers in place of two and four: an eager
    count is additive from one layer on, and its cost grows with depth);
    xlstm and zamba2 keep one and two periods of their block pattern."""
    fam = cfg.family
    if fam == "whisper":
        pts = [({"enc_layers": 1, "n_layers": 1}, (1, 1)),
               ({"enc_layers": 2, "n_layers": 1}, (2, 1)),
               ({"enc_layers": 1, "n_layers": 2}, (1, 2))]
        return pts, (cfg.enc_layers, cfg.n_layers)
    if fam == "xlstm":
        e = cfg.ssm.slstm_every
        pts = [({"n_layers": e}, (e,)), ({"n_layers": 2 * e}, (2 * e,))]
        return pts, (cfg.n_layers,)
    if fam == "zamba2":
        e = cfg.attn_every
        pts = [({"n_layers": e}, (e,)), ({"n_layers": 2 * e}, (2 * e,))]
        return pts, (cfg.n_layers,)
    if cfg.moe is not None:
        moe = cfg.moe

        def m(ld, lm):
            return {"n_layers": ld + lm,
                    "moe": dataclasses.replace(moe, n_dense_layers=ld)}
        pts = [(m(1, 1), (1, 1)), (m(1, 2), (1, 2)), (m(2, 1), (2, 1))]
        return pts, (moe.n_dense_layers, cfg.n_layers - moe.n_dense_layers)
    pts = [({"n_layers": 1}, (1,)), ({"n_layers": 2}, (2,))]
    return pts, (cfg.n_layers,)


#: the lengths at which xlstm's sLSTM-only point is counted
SLSTM_LENGTHS = (16, 32)


def _xlstm_plan(cfg, shape):
    """xlstm's train and prefill points by block kind and length, or None
    (the cell is counted at its own length on ``_layer_plan``'s points).

    A point is (overrides, T, [1, T, n_m, n_m T, n_s, n_s T]): an
    mLSTM-only stack of one and of two blocks (``slstm_every`` 0) at one
    and two chunks, and a one-block sLSTM-only stack (``slstm_every`` 1)
    at ``SLSTM_LENGTHS``, where the token loop is short. Block costs add
    by kind and are affine in T (the mLSTM at multiples of its chunk), so
    the six counts fix M = a + a' T + n_m (b_m + b_m' T) + n_s (b_s + b_s'
    T) exactly; the target is the cell's (n_m, n_s, T)."""
    if cfg.family != "xlstm" or shape.kind == "decode":
        return None
    c = cfg.ssm.chunk
    if shape.seq_len <= 2 * c:
        return None
    ssm = cfg.ssm

    def pt(n_layers, every, n_m, n_s, t):
        return ({"n_layers": n_layers,
                 "ssm": dataclasses.replace(ssm, slstm_every=every)},
                t, [1, t, n_m, n_m * t, n_s, n_s * t])
    pts = [pt(1, 1, 0, 1, t) for t in SLSTM_LENGTHS]
    pts += [pt(k, 0, k, 0, t) for k in (1, 2) for t in (c, 2 * c)]
    every = ssm.slstm_every
    n_s = sum(1 for i in range(cfg.n_layers)
              if every and i % every == every - 1)
    n_m, t = cfg.n_layers - n_s, shape.seq_len
    return pts, [1, t, n_m, n_m * t, n_s, n_s * t]


def _flatten(rec: Dict) -> Dict[str, int]:
    """A count record's numeric fields as one flat dict."""
    out = {f: rec[f] for f in _FIELDS}
    out["coll_ops"] = rec["collective_ops"]
    for dt, v in rec["flops_by_dtype"].items():
        out[f"flops/{dt}"] = v
    for kind, v in rec["collectives"].items():
        out[f"coll/{kind}"] = v
    return out


def _combine(a: Dict, b: Dict, k: int = 1) -> Dict:
    """a + k * b over the union of their keys."""
    return {key: a.get(key, 0) + k * b.get(key, 0) for key in set(a) | set(b)}


def solve_exact(rows: List[List[int]], ys: List[int]) -> List[Fraction]:
    """The solution of the square system ``rows @ x = ys`` in rationals
    (Gauss-Jordan with Fractions: no rounding)."""
    n = len(rows)
    m = [[Fraction(v) for v in r] + [Fraction(y)] for r, y in zip(rows, ys)]
    for col in range(n):
        piv = next(i for i in range(col, n) if m[i][col] != 0)
        m[col], m[piv] = m[piv], m[col]
        p = m[col][col]
        m[col] = [v / p for v in m[col]]
        for i in range(n):
            if i != col and m[i][col] != 0:
                f = m[i][col]
                m[i] = [a - f * b for a, b in zip(m[i], m[col])]
    return [m[i][n] for i in range(n)]


def _num(x: Fraction):
    """An integral solution as an int (exact at any size), else a float."""
    return int(x) if x.denominator == 1 else float(x)


def _design(lv: Tuple[int, ...]) -> List[int]:
    return [1] + list(lv)


def account_cell(arch: str, shape_name, mesh, cim=None,
                 verbose: bool = True, overrides: Optional[Dict] = None,
                 run_overrides: Optional[Dict] = None,
                 accum: Optional[int] = None, reduced: bool = False) -> Dict:
    """Exact per-device totals of one rank's step: ``hlo_flops``,
    ``hlo_bytes``, ``collective_bytes`` (the reference's keys), with the
    FLOPs by dtype, the collective bytes by kind, the peak estimate and the
    seconds the counts took (``count_s``). ``mesh`` is a
    ``launch.mesh.MeshShape``; ``cim`` a CIM config or None; ``shape_name``
    a name of ``SHAPES`` or a ``Shape``; the depth solved for is that of
    the config after ``overrides``."""
    from .cells import make_run_config
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    cfg = get_config(arch, reduced=reduced)
    if overrides:
        cfg = cfg.replace(**overrides)
    plan = _xlstm_plan(cfg, shape)
    if plan is None:
        lpts, target = _layer_plan(cfg)
        pts = [(ov, None, _design(lv)) for ov, lv in lpts]
        want = _design(target)
    else:
        pts, want = plan
    user_ov = dict(overrides or {})
    target_accum = (accum if accum is not None
                    else make_run_config(arch, shape,
                                         run_overrides=run_overrides
                                         ).accum_steps)
    t0 = time.perf_counter()

    def measure(ov, sh, a):
        return _flatten(count_cell(arch, sh, mesh, cim=cim, overrides=ov,
                                   accum=a, run_overrides=run_overrides,
                                   reduced=reduced))

    rows, values = [], []
    for ov_pt, t, row in pts:
        ov = {**user_ov, **ov_pt}
        sh = shape if t is None else dataclasses.replace(shape, seq_len=t)
        m = measure(ov, sh, 1)
        if shape.kind == "train" and target_accum > 1:
            m2 = measure(ov, sh, 2)
            p1, p2 = m["peak"], m2["peak"]
            m = _combine(m, _combine(m2, m, -1), target_accum - 1)
            # a microbatch's activations shrink as 1/A: the peak is
            # P(inf) + (P(1) - P(inf)) / A, P(inf) = 2 P(2) - P(1)
            m["peak"] = (2 * p2 - p1) + Fraction(2 * (p1 - p2),
                                                 target_accum)
        rows.append(row)
        values.append(m)
    out: Dict[str, float] = {}
    for key in set().union(*values):
        coef = solve_exact(rows, [v.get(key, 0) for v in values])
        total = sum(c * w for c, w in zip(coef, want))
        out[key] = max(total, 0)
    if plan is not None:
        # a peak is a maximum, not a sum by block kind: xlstm's is solved
        # on the mLSTM-only points, as if every block were an mLSTM block
        n, t = want[2] + want[4], want[1]
        coef = solve_exact([r[:4] for r in rows[2:]],
                           [v["peak"] for v in values[2:]])
        out["peak"] = max(sum(c * w for c, w in zip(coef,
                                                    [1, t, n, n * t])), 0)
    count_s = time.perf_counter() - t0
    coll = {k[5:]: _num(v) for k, v in out.items() if k.startswith("coll/")}
    rec = {"hlo_flops": _num(out["flops"]), "hlo_bytes": _num(out["bytes"]),
           "collective_bytes": sum(coll.values()),
           "flops_by_dtype": {k[6:]: _num(v) for k, v in out.items()
                              if k.startswith("flops/")},
           "collectives": coll, "collective_ops": _num(out["coll_ops"]),
           "peak_bytes": _num(out["peak"]),
           "points": len(values), "count_s": round(count_s, 2)}
    if verbose:
        print(f"[account] {arch} x {shape.name}: per-dev flops "
              f"{rec['hlo_flops']:.3e} bytes {rec['hlo_bytes']:.3e} coll "
              f"{rec['collective_bytes']:.3e} ({len(values)} counts, "
              f"{count_s:.1f}s)")
    return rec
