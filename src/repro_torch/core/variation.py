"""Memory-cell variation model (paper §IV-E, Eq. 5) and its drift over
time, counterpart of ``repro.core.variation``.

Device non-idealities are multiplicative log-normal noise on the stored
cell conductances: ``d_var = d * exp(sigma * theta)``, ``theta ~ N(0, 1)``,
drawn per physical cell of the bit-split digit planes.

Noise is always laid out over the **logical packed plane**: (S, k_tiles,
rows, N) for linear, (S, k_tiles, kh, kw, c_per_array, C_out) for conv,
with nibble planes unpacked first. Emulate and deploy both index that
layout, so the same theta reaches the same cell on both paths and the two
agree bit for bit within the port.

Randomness does not cross frameworks, so the port takes the noise in one
of two forms (a *variation*):

* a **theta tensor** (or numpy array) over the logical shape, e.g. drawn
  by the JAX package and handed over for a parity test;
* a **variation source** (``VariationSource``): the port's ``Sampler``,
  (seed, Monte-Carlo sample index, layer name), draws theta with
  ``torch.randn`` from a ``torch.Generator`` seeded by a hash of (seed,
  sample, layer), on the planes' device. Theta does not depend on sigma,
  so sample ``i`` sees the same field at every sigma (common random
  numbers). A parity test's source hands in the JAX package's draws.
  ``for_layer(path)`` gives a packed-tree node its own source (the
  reference's ``path_fold_key``), ``split(n)`` one source per layer of a
  stacked node or per expert of a bank (the reference's
  ``jax.random.split``): ``api.pack_model`` bakes variation so.

The factor is ``exp(sigma * theta)`` in float32, as in the reference.

Temporal drift (DESIGN.md §11): ``sigma`` may also be a ``DriftState``,
a ``DriftSchedule`` (static rates) at a request count ``t``. Everywhere
a sigma flows (the forwards, the kernel dispatch, ``perturb_packed``) a
DriftState flows the same way, and ``variation_noise`` dispatches on it:
the factor is then the composed drift field of ``drift_field``, and the
variation is a **drift source** (``DriftSource``): the port's
``Sampler``, or any object with the same four methods (a parity test's
source hands in fields drawn by the JAX package). ``drift_tree`` draws
one chip realization of a whole packed model tree, each node from its
own source (``source.for_layer(path)``).

Column-parallel serving (DESIGN.md §10): on a column-sharded node
(``core.colshard``) every rank draws the field over the full unpadded
logical planes from the same source and keeps its own columns
(``perturb_cols``), so a sharded realization is the single-device one,
split.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Optional, Protocol, Sequence

import numpy as np
import torch

from .colshard import (col_apply, is_col_sharded, localize, range_of,
                       wrap)
from .nibble import is_nibble_packed, unpack_nibbles


@dataclasses.dataclass(frozen=True)
class Sampler:
    """A keyed source of theta fields: one Monte-Carlo device realization
    per (seed, sample), one independent field per layer name. The noise
    level is not part of it: forwards take ``variation_std``, else
    ``cfg.variation_std``."""

    seed: int
    sample: int = 0
    layer: str = ""

    def at(self, sample: int) -> "Sampler":
        """The same sampler for Monte-Carlo sample ``sample`` (the
        counterpart of ``jax.random.fold_in(key, sample)``)."""
        return dataclasses.replace(self, sample=int(sample))

    def for_layer(self, name) -> "Sampler":
        """The sampler of the layer ``name`` (the counterpart of the
        reference's per-layer key split), or of the packed-tree node at
        the path ``name`` (a tuple of parts, hashed as the reference's
        ``path_fold_key`` hashes it)."""
        if isinstance(name, (tuple, list)):
            name = f"node{path_hash(name)}"
        return dataclasses.replace(self, layer=str(name))

    def generator_seed(self) -> int:
        tag = f"{self.seed}/{self.sample}/{self.layer}".encode()
        return int.from_bytes(hashlib.sha256(tag).digest()[:8],
                              "little") & (2 ** 63 - 1)

    def theta(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """Standard-normal float32 field over ``shape`` on ``device``."""
        return self._normal(self.generator_seed(), shape, device)

    def split(self, n: int) -> list:
        """``n`` independent samplers, one per layer of a stacked node or
        expert of a bank (the counterpart of ``jax.random.split(key,
        n)``)."""
        return [dataclasses.replace(self, layer=f"{self.layer}/{i}")
                for i in range(int(n))]

    # -- the drift source protocol (``DriftSource``) -------------------------

    def read(self, shape: Sequence[int], t: int, device=None) -> torch.Tensor:
        """The read-noise field at request count ``t`` (redrawn per t)."""
        return self._normal(self._component_seed(f"read/{int(t)}"), shape,
                            device)

    def cell(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """The persistent per-cell field (the same at every t)."""
        return self._normal(self._component_seed("cell"), shape, device)

    def col(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """The persistent per-column field (the same at every t)."""
        return self._normal(self._component_seed("col"), shape, device)

    def _component_seed(self, what: str) -> int:
        tag = f"{self.seed}/{self.sample}/{self.layer}/drift/{what}".encode()
        return int.from_bytes(hashlib.sha256(tag).digest()[:8],
                              "little") & (2 ** 63 - 1)

    @staticmethod
    def _normal(seed: int, shape: Sequence[int], device) -> torch.Tensor:
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return torch.randn(tuple(shape), generator=gen, device=device,
                           dtype=torch.float32)


class VariationSource(Protocol):
    """Where cell-variation theta comes from, one field per packed-tree
    node. ``Sampler`` implements it; a parity test implements it with the
    JAX package's own draws."""

    def for_layer(self, name) -> "VariationSource":
        """The source of the layer ``name`` or of the packed-tree node at
        the path ``name`` (a tuple)."""

    def split(self, n: int) -> list:
        """``n`` independent sources (the layers of a stacked node, the
        experts of a bank)."""

    def theta(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """A standard-normal float32 field over ``shape``."""


class DriftSource(Protocol):
    """Where drift fields come from: standard-normal float32 fields, one
    set per node of a packed tree. The persistent components (``cell``,
    ``col``) do not depend on ``t``; ``read`` is redrawn per ``t``.
    ``Sampler`` implements it; a parity test implements it with the JAX
    package's own draws."""

    def for_layer(self, name) -> "DriftSource":
        """The source of the layer ``name`` or of the packed-tree node at
        the path ``name`` (a tuple)."""

    def read(self, shape: Sequence[int], t: int, device=None) -> torch.Tensor:
        """The read-noise field at request count ``t``."""

    def cell(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """The per-cell field over ``shape``."""

    def col(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """The per-column field over ``shape`` (``_column_field_shape``)."""


@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """Sigma schedule of a drift process indexed by the request count
    ``t`` (model invocations served). Three independent log-normal
    components compose multiplicatively on the cell conductances, all
    sigmas in log space:

      read    transient read noise, redrawn at every t:
              sigma_read(t) = read_sigma + read_rate * t;
      cell    a persistent per-cell bias, sigma_cell(t) = cell_rate * t,
              the same realization at every t, only its magnitude grows;
      column  a persistent per-column gain, sigma_col(t) = col_rate * t,
              one theta per (split, k_tile, column), shared by every cell
              of the bitline: what the paper's column-wise scales absorb,
              and what in-service recalibration re-fits
              (``eval/recalibrate.py``).
    """

    read_sigma: float = 0.0
    read_rate: float = 0.0
    cell_rate: float = 0.0
    col_rate: float = 0.0

    @property
    def is_static_zero(self) -> bool:
        return (self.read_sigma <= 0.0 and self.read_rate <= 0.0
                and self.cell_rate <= 0.0 and self.col_rate <= 0.0)

    def at(self, t: int) -> "DriftState":
        return DriftState(schedule=self, t=int(t))


@dataclasses.dataclass(frozen=True)
class DriftState:
    """A ``DriftSchedule`` evaluated at request count ``t`` (a Python
    int). Pass it wherever a ``variation_std`` sigma is accepted."""

    schedule: DriftSchedule
    t: int


def _column_field_shape(shape) -> tuple:
    """The per-column broadcast shape of a packed plane shape: the row
    dims collapse to 1, one theta per (split, k_tile, column). Packed
    layouts are (S, kt, rows..., N), linear 4-D and conv 6-D, with an
    optional leading layer axis for stacked nodes (5-D / 7-D)."""
    shape = tuple(int(d) for d in shape)
    lead = 1 if len(shape) in (5, 7) else 0
    return (shape[:lead + 2] + (1,) * (len(shape) - lead - 3)
            + (shape[-1],))


def drift_field(source, shape: Sequence[int], state: DriftState,
                device=None) -> torch.Tensor:
    """Multiplicative drift factor over a packed plane shape at request
    count ``state.t``: exp of the sum of the active components'
    log-fields, added in the order read, cell, column and in float32, as
    the reference adds them. The column component comes at
    ``_column_field_shape(shape)`` and broadcasts; components whose rates
    are zero are not drawn, so a column-only schedule never draws a
    full-plane field."""
    sch, t = state.schedule, int(state.t)
    shape = tuple(int(d) for d in shape)
    tf = np.float32(t)
    log_f = torch.zeros((1,) * len(shape), dtype=torch.float32, device=device)
    if sch.read_sigma > 0.0 or sch.read_rate > 0.0:
        sig = np.float32(np.float32(sch.read_sigma)
                         + np.float32(np.float32(sch.read_rate) * tf))
        log_f = log_f + _scaled(sig, source.read(shape, t, device))
    if sch.cell_rate > 0.0:
        sig = np.float32(np.float32(sch.cell_rate) * tf)
        log_f = log_f + _scaled(sig, source.cell(shape, device))
    if sch.col_rate > 0.0:
        sig = np.float32(np.float32(sch.col_rate) * tf)
        log_f = log_f + _scaled(sig, source.col(_column_field_shape(shape),
                                                device))
    return torch.exp(log_f)


def _scaled(sig: np.float32, theta: torch.Tensor) -> torch.Tensor:
    """``sig * theta`` in float32."""
    return torch.tensor(float(sig), dtype=torch.float32,
                        device=theta.device) * theta.to(torch.float32)


def resolve_sigma(variation_std, default=None):
    """The sigma a forward uses: ``variation_std`` when given, else
    ``default`` (``cfg.variation_std``)."""
    return default if variation_std is None else variation_std


def is_static_zero(sigma) -> bool:
    """True when sigma disables variation: None, a number <= 0, or a
    ``DriftState`` whose schedule has every rate at zero."""
    if isinstance(sigma, DriftState):
        return sigma.schedule.is_static_zero
    return sigma is None or (isinstance(sigma, (int, float)) and sigma <= 0.0)


def variation_wanted(variation, sigma) -> bool:
    """The one gate every path uses: noise is injected iff a variation is
    given and sigma is not zero."""
    return variation is not None and not is_static_zero(sigma)


def variation_noise(variation, shape: Sequence[int], sigma,
                    device=None) -> torch.Tensor:
    """Multiplicative log-normal factor ``exp(sigma * theta)`` over
    ``shape``, float32, theta from a variation source (its
    ``theta(shape, device)``) or a tensor. A theta tensor is reshaped to
    ``shape`` (its element count must match: a conv field may come 6-D or
    flattened).
    When ``sigma`` is a ``DriftState``, ``variation`` is a drift source
    and the factor is ``drift_field``'s, which broadcasts against
    ``shape``."""
    if isinstance(sigma, DriftState):
        return drift_field(variation, shape, sigma, device)
    if hasattr(variation, "theta"):                 # a variation source
        theta = variation.theta(shape, device)
    else:
        if not isinstance(variation, torch.Tensor):
            variation = torch.from_numpy(np.array(variation, np.float32))
        theta = variation.to(device=device, dtype=torch.float32)
        if theta.numel() != int(np.prod(shape)):
            raise ValueError(f"theta of shape {tuple(theta.shape)} does not "
                             f"cover planes of shape {tuple(shape)}")
        theta = theta.reshape(tuple(shape))
    sig = torch.tensor(float(sigma), dtype=torch.float32, device=theta.device)
    return torch.exp(sig * theta)


def perturb_cols(local: torch.Tensor, cols, variation, sigma, *,
                 shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``perturb_digits`` of one rank's columns (``cols``, a
    ``core.colshard.ColRange``) of logical planes: the field is drawn over
    the full unpadded logical planes, as on one device, and the rank
    keeps its columns, so every rank's share equals the single-device
    planes' columns bit for bit."""
    d = local.to(torch.float32)
    full = tuple(d.shape[:-1]) + (cols.n,)
    noise = variation_noise(variation, shape or full, sigma, device=d.device)
    if noise.numel() != math.prod(full):  # a drift field's column form
        full = _column_field_shape(full)
    return d * localize(noise.reshape(full), cols, 1.0)


def perturb_digits(digits: torch.Tensor, variation, sigma, *,
                   shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Perturb logical digit planes; returns float32 (noisy conductances
    are not integers, so they are never cast back). ``shape`` is the
    layout the noise is drawn over when it differs from ``digits.shape``
    with the same element count (the 6-D conv layout of flattened
    planes). Column-sharded planes perturb their local columns
    (``perturb_cols``) and stay sharded."""
    if is_col_sharded(digits):
        cols = range_of(digits)
        if not variation_wanted(variation, sigma):
            return wrap(digits.to_local().to(torch.float32), cols)
        return wrap(perturb_cols(digits.to_local(), cols, variation, sigma,
                                 shape=shape), cols)
    d = digits.to(torch.float32)
    if not variation_wanted(variation, sigma):
        return d
    noise = variation_noise(variation, shape or d.shape, sigma,
                            device=d.device)
    if noise.numel() != d.numel():        # a drift field's column form
        return d * noise.reshape(_column_field_shape(d.shape))
    return d * noise.reshape(d.shape)


def apply_cell_variation(digits: torch.Tensor, variation,
                         sigma) -> torch.Tensor:
    """Perturb cell values, ``d -> d * exp(theta)``, cast back to the
    planes' dtype (``perturb_digits`` keeps float32)."""
    if is_static_zero(sigma):
        return digits
    noisy = digits.to(torch.float32) * variation_noise(
        variation, digits.shape, sigma, device=digits.device)
    return noisy.to(digits.dtype)


def perturb_packed(packed: Dict[str, torch.Tensor], variation, sigma, *,
                   sample: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One Monte-Carlo device realization of a packed layer: a new dict
    whose ``w_digits`` are float32 logical planes carrying the noise;
    scales, metadata and the ``w_occ`` map pass through (multiplicative
    noise keeps dead cells dead). Nibble planes are unpacked first, so a
    nibble and a dense pack perturb the same cell with the same theta.
    ``sample`` selects the sampler's Monte-Carlo sample."""
    if sample is not None:
        if not hasattr(variation, "at"):
            raise TypeError("perturb_packed: `sample` selects a Sampler's "
                            "Monte-Carlo sample; a theta tensor is one "
                            "realization already")
        variation = variation.at(sample)
    out = dict(packed)
    d = packed["w_digits"]
    if is_nibble_packed(d):
        d = col_apply(unpack_nibbles, d)
    out["w_digits"] = perturb_digits(d, variation, sigma)
    return out


# ---------------------------------------------------------------------------
# whole-tree drift injection (the serving engine's chip model)
# ---------------------------------------------------------------------------

def path_hash(path) -> int:
    """The integer the reference's ``path_fold_key`` folds into its key
    for a tree path (a tuple of parts): stable under tree growth, so
    drift injection and scale-delta fitting key nodes identically."""
    h = 0
    for part in path:
        for ch in str(part):
            h = (h * 131 + ord(ch)) % (2 ** 31 - 1)
        h = (h * 131 + 7) % (2 ** 31 - 1)
    return h


def drift_tree(params, source, state: DriftState):
    """One chip realization of a packed model tree at request count
    ``state.t``: every node holding ``w_digits`` gets float32 planes
    perturbed by the drift field of its own source,
    ``source.for_layer(path)``; scales, metadata and the other leaves pass
    through as the same objects, and the integer planes are never
    repacked. Stacked nodes (a leading layer axis) take the field over
    their whole shape. As in the reference, only ``w_digits`` nodes
    drift: the MoE banks (``wg_digits``, ``wu_digits``, ``wd_digits``)
    pass through. A schedule with every rate at zero returns ``params``
    itself. On the card the new planes are checked against the
    float-digit kernel's exactness bound with one host read for the whole
    tree (``kernels.cim_matmul.check_float_planes``), so their launches
    need not each read their planes back."""
    if is_static_zero(state):
        return params
    planes = []

    def walk(node, path):
        if isinstance(node, dict):
            if "w_digits" in node:
                out = perturb_packed(node, source.for_layer(path), state)
                planes.append(out["w_digits"])
                return out
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return node
    out = walk(params, ())
    # walk's closure holds the list and walk itself (a cycle the collector
    # frees late): empty it, or the realization's planes outlive the call
    drifted = [p.to_local() if is_col_sharded(p) else p for p in planes]
    planes.clear()
    if any(p.is_cuda for p in drifted):
        from repro_torch.kernels.cim_matmul import check_float_planes
        check_float_planes(drifted)
    return out
