"""In-service column-scale recalibration (DESIGN.md §11), counterpart of
``repro.eval.recalibrate``.

The paper's column-wise scale factors absorb cell variation at QAT
time; this module re-fits them in the field against conductance drift,
without touching the packed digit planes. Every physical array column
is a one-parameter channel: probe row codes drive the pristine planes
and the drifted planes through the same column MAC, and the
least-squares gain

    g[s, t, n] = sum_p P_ref * P_obs / sum_p P_ref^2

maps clean partial sums to drifted ones per (split, k_tile, column).
Column-gain drift is recovered exactly (the partial sum is linear in
the column's cells); per-cell drift is absorbed in the least-squares
sense.

A fitted ``ScaleDelta`` corrects the serving arithmetic in two places:
``s_p' = s_p * g`` re-centers the ADC range on the drifted partial sums
(reduced to the psum-scale granularity when coarser than COLUMN), and
``deq_scale = 1/g`` (the optional packed-node leaf the deploy forwards
read) divides the gain back out of the dequantized output.

Deltas are **absolute**: fitted against the pristine artifact and applied
to the pristine artifact. They are written in the reference's on-disk
format (the checkpoint leaf store plus ``delta.json``), so either package
loads the other's delta bit for bit. The einsums run in full float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.api.artifact import (ARTIFACT_LAYOUT_VERSION,
                                      SCALE_DELTA_VERSION, _DELTA_WRITERS,
                                      _LAYOUT_WRITERS, ArtifactVersionError,
                                      DeployArtifact)
from repro_torch.checkpoint import ckpt as _ckpt
from repro_torch.core import colshard
from repro_torch.core.nibble import is_nibble_packed, unpack_nibbles
from repro_torch.kernels.ref import einsum_f32

_EPS = 1e-12
_FORMAT = "repro.eval.ScaleDelta"


def _joined_leaves(tree, prefix: str = "") -> Dict[str, Any]:
    """{'/'-joined path: leaf} of a nested dict (the leaf store splits
    the gains' '/'-joined node names into nested dicts on restore)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        out.update(_joined_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@dataclasses.dataclass(frozen=True)
class ScaleDelta:
    """A versioned column-gain correction for one packed model tree.

    ``gains`` maps '/'-joined packed-node paths to the fitted per-column
    psum gain (float32 tensors on the CPU), shaped like the node's full
    psum scale, (S, kt, N), with a leading layer axis for stacked nodes.
    ``layout_version`` pins the artifact layout the delta was fitted
    against."""

    gains: Dict[str, torch.Tensor]
    delta_version: int = SCALE_DELTA_VERSION
    layout_version: int = ARTIFACT_LAYOUT_VERSION
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        stale = os.path.join(path, "delta.json")
        if os.path.exists(stale):
            os.remove(stale)
        _ckpt.save(path, 0, {"gains": dict(self.gains)})
        head = {
            "format": _FORMAT,
            "delta_version": self.delta_version,
            "layout_version": self.layout_version,
            "meta": self.meta,
        }
        jpath = os.path.join(path, "delta.json")
        tmp = jpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(head, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, jpath)
        return path

    @classmethod
    def load(cls, path: str) -> "ScaleDelta":
        jpath = os.path.join(path, "delta.json")
        if not os.path.exists(jpath):
            raise FileNotFoundError(f"{path} is not a ScaleDelta "
                                    "(no delta.json)")
        with open(jpath) as f:
            head = json.load(f)
        dv = head.get("delta_version")
        if dv is None or dv > SCALE_DELTA_VERSION:
            raise ArtifactVersionError(
                f"ScaleDelta at {path}", "delta_version", dv,
                SCALE_DELTA_VERSION, writers=_DELTA_WRITERS)
        tree = _ckpt.restore_tree(path, step=0, device="cpu")
        return cls(gains=_joined_leaves(tree["gains"]), delta_version=dv,
                   layout_version=head["layout_version"],
                   meta=dict(head.get("meta", {})))


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def _row_flat(planes: torch.Tensor) -> torch.Tensor:
    """Packed planes -> (lead?, S, kt, R, N) float32, rows flattened
    row-major (the same order on the 4-D linear and 6-D conv layouts).
    Nibble planes are unpacked first, so a pristine int4 pack fits
    against drifted float planes (which are always logical)."""
    if is_nibble_packed(planes):
        planes = unpack_nibbles(planes)
    lead = 1 if planes.ndim in (5, 7) else 0
    shape = tuple(planes.shape)
    rows = int(np.prod(shape[lead + 2:-1]))
    return planes.to(torch.float32).reshape(shape[:lead + 2]
                                            + (rows, shape[-1]))


def _gain_4d(d_ref: torch.Tensor, d_obs: torch.Tensor,
             codes: torch.Tensor) -> torch.Tensor:
    """Least-squares per-column gain from probe codes (P, kt, R) driving
    (S, kt, R, N) pristine and observed planes -> (S, kt, N)."""
    p_ref = einsum_f32("ptr,strn->pstn", codes, d_ref)
    p_obs = einsum_f32("ptr,strn->pstn", codes, d_obs)
    num = torch.sum(p_ref * p_obs, dim=0)
    den = torch.sum(p_ref * p_ref, dim=0)
    # all-zero columns (padding, dead filters) carry no signal: gain 1
    return torch.where(den > _EPS, num / torch.clamp_min(den, _EPS),
                       torch.ones_like(den))


def rademacher_codes(gen: torch.Generator, probes: int, k_tiles: int,
                     rows: int) -> torch.Tensor:
    """(probes, k_tiles, rows) float32 +-1 probe codes drawn from ``gen``
    (on the generator's device)."""
    bits = torch.randint(0, 2, (probes, k_tiles, rows), generator=gen,
                         device=gen.device)
    return (2 * bits - 1).to(torch.float32)


def node_gain(ref_planes: torch.Tensor, obs_planes: torch.Tensor, *,
              gen: Optional[torch.Generator] = None, probes: int = 32,
              codes=None) -> torch.Tensor:
    """Fit one packed node's per-column gain. ``codes`` (P, kt, R) are the
    probe rows (activation codes replayed from recent requests, or probes
    drawn elsewhere); without them, Rademacher +-1 probes are drawn from
    ``gen``. Stacked nodes (a leading layer axis) share the codes."""
    d_ref, d_obs = _row_flat(ref_planes), _row_flat(obs_planes)
    kt, rows = d_ref.shape[-3], d_ref.shape[-2]
    if codes is None:
        if gen is None:
            raise ValueError("node_gain needs `codes` or a probe generator "
                             "`gen`")
        codes = rademacher_codes(gen, probes, kt, rows)
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.array(codes, np.float32))
    codes = codes.to(device=d_ref.device, dtype=torch.float32)
    d_obs = d_obs.to(d_ref.device)
    if d_ref.ndim == 5:
        return torch.stack([_gain_4d(r, o, codes)
                            for r, o in zip(d_ref, d_obs)])
    return _gain_4d(d_ref, d_obs, codes)


def fit_scale_delta(reference, observed, *,
                    gen: Optional[torch.Generator] = None, probes: int = 32,
                    codes: Optional[Mapping[str, Any]] = None,
                    meta: Optional[Dict[str, Any]] = None) -> ScaleDelta:
    """Fit a ``ScaleDelta`` mapping ``reference`` (the pristine packed
    tree, or a ``DeployArtifact``) to ``observed`` (the same tree with
    drifted planes, e.g. ``core.variation.drift_tree``'s, or planes read
    back from a real chip).

    ``codes`` optionally gives per-node probe codes ({'/'-joined path:
    (P, kt, R)}); nodes without an entry draw Rademacher probes from
    ``gen``, node after node in the tree's order."""
    layout = ARTIFACT_LAYOUT_VERSION
    if isinstance(reference, DeployArtifact):
        layout = reference.layout_version
        reference = reference.params
    if isinstance(observed, DeployArtifact):
        observed = observed.params
    gains: Dict[str, torch.Tensor] = {}

    def walk(ref, obs, path):
        if isinstance(ref, dict):
            if "w_digits" in ref:
                name = "/".join(path)
                node_codes = codes.get(name) if codes else None
                # a column-sharded node's planes are gathered (every rank
                # fits the same full-width gain)
                g = node_gain(colshard.full_leaf(ref["w_digits"]),
                              colshard.full_leaf(obs["w_digits"]), gen=gen,
                              probes=probes, codes=node_codes)
                gains[name] = g.cpu()
                return
            for k in ref:
                walk(ref[k], obs[k], path + (k,))
        elif isinstance(ref, (list, tuple)):
            for i, v in enumerate(ref):
                walk(v, obs[i], path + (str(i),))
    walk(reference, observed, ())
    return ScaleDelta(gains=gains, layout_version=layout,
                      meta=dict(meta or {}))


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------

def _reduce_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a full (..., S, kt, N) gain to a coarser psum-scale shape
    (ARRAY/LAYER granularities) by averaging the broadcast group. The
    range re-centering is approximate there; the exact correction still
    lands in ``deq_scale``, which is always full-column."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    for ax in range(-1, -len(shape) - 1, -1):
        if g.shape[ax] != shape[ax]:
            g = g.mean(dim=ax, keepdim=True)
    return torch.broadcast_to(g, shape)


def _placed_like(arr: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``arr`` on ``ref``'s device with ``ref``'s column placement (both
    end in the column axis): on a column-sharded node this rank keeps, and
    later multiplies, only its own columns of a full-width gain."""
    if colshard.is_col_sharded(ref):
        return colshard.shard_leaf(arr, ref.device_mesh,
                                   colshard.range_of(ref).axis,
                                   device=ref.to_local().device)
    return arr.to(ref.device)


def apply_scale_delta_params(params, delta: ScaleDelta):
    """Apply a delta to a pristine packed tree: per fitted node,
    ``s_p *= reduce(g)`` and ``deq_scale = 1/g``; digit planes and every
    other leaf pass through as the same objects. Nodes the delta does not
    name are left alone."""
    def walk(node, path):
        if isinstance(node, dict):
            name = "/".join(path)
            if "w_digits" in node and name in delta.gains:
                g = torch.as_tensor(delta.gains[name], dtype=torch.float32)
                out = dict(node)
                s_p = node["s_p"]
                g_sp = _placed_like(_reduce_to(g, s_p.shape), s_p)
                out["s_p"] = colshard.col_apply(
                    lambda s, gs: (s.to(torch.float32) * gs).to(s.dtype),
                    s_p, g_sp)
                out["deq_scale"] = _placed_like(1.0 / g, node["w_digits"])
                return out
            if "w_digits" in node:
                return node
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return node
    return walk(params, ())


def apply_scale_delta(artifact: DeployArtifact,
                      delta: ScaleDelta) -> DeployArtifact:
    """Apply a ``ScaleDelta`` to a loaded ``DeployArtifact``. Deltas are
    absolute with respect to the pristine artifact they were fitted from,
    so applying one to an already recalibrated artifact is refused. A
    delta fitted against another artifact layout, or written by a newer
    delta format, raises ``ArtifactVersionError``."""
    if delta.delta_version > SCALE_DELTA_VERSION:
        raise ArtifactVersionError(
            "ScaleDelta", "delta_version", delta.delta_version,
            SCALE_DELTA_VERSION, writers=_DELTA_WRITERS)
    if delta.layout_version != artifact.layout_version:
        raise ArtifactVersionError(
            "ScaleDelta (stale)", "layout_version", delta.layout_version,
            artifact.layout_version, writers=_LAYOUT_WRITERS,
            relation="==",
            detail="The delta was fitted against a different artifact "
                   "layout; re-fit it against this artifact.")
    if "delta_version" in artifact.meta:
        raise ValueError(
            "apply_scale_delta: artifact already carries a ScaleDelta "
            "(meta['delta_version'] set); deltas are absolute — apply to "
            "the pristine artifact instead of compounding.")
    params = apply_scale_delta_params(artifact.params, delta)
    meta = {**artifact.meta, "delta_version": delta.delta_version,
            "recal": dict(delta.meta)}
    return dataclasses.replace(artifact, params=params, meta=meta)
