"""Memory-cell variation model (paper §IV-E, Eq. 5), counterpart of
``repro.core.variation`` for static sigma.

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
* a ``Sampler``: (seed, Monte-Carlo sample index, layer name). It draws theta with ``torch.randn`` from a ``torch.Generator``
  seeded by a hash of (seed, sample, layer), on the planes' device. Theta
  does not depend on sigma, so sample ``i`` sees the same field at every
  sigma (common random numbers).

The factor is ``exp(sigma * theta)`` in float32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch

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

    def for_layer(self, name: str) -> "Sampler":
        """The sampler of the layer ``name`` (the counterpart of the
        reference's per-layer key split)."""
        return dataclasses.replace(self, layer=str(name))

    def generator_seed(self) -> int:
        tag = f"{self.seed}/{self.sample}/{self.layer}".encode()
        return int.from_bytes(hashlib.sha256(tag).digest()[:8],
                              "little") & (2 ** 63 - 1)

    def theta(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """Standard-normal float32 field over ``shape`` on ``device``."""
        device = torch.device("cpu" if device is None else device)
        gen = torch.Generator(device=device)
        gen.manual_seed(self.generator_seed())
        return torch.randn(tuple(shape), generator=gen, device=device,
                           dtype=torch.float32)


def resolve_sigma(variation_std, default=None):
    """The sigma a forward uses: ``variation_std`` when given, else
    ``default`` (``cfg.variation_std``)."""
    return default if variation_std is None else variation_std


def is_static_zero(sigma) -> bool:
    """True when sigma disables variation (None or a number <= 0)."""
    return sigma is None or (isinstance(sigma, (int, float)) and sigma <= 0.0)


def variation_wanted(variation, sigma) -> bool:
    """The one gate every path uses: noise is injected iff a variation is
    given and sigma is not zero."""
    return variation is not None and not is_static_zero(sigma)


def variation_noise(variation, shape: Sequence[int], sigma,
                    device=None) -> torch.Tensor:
    """Multiplicative log-normal factor ``exp(sigma * theta)`` over
    ``shape``, float32. A theta tensor is reshaped to ``shape`` (its
    element count must match: a conv field may come 6-D or flattened)."""
    if isinstance(variation, Sampler):
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


def perturb_digits(digits: torch.Tensor, variation, sigma, *,
                   shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Perturb logical digit planes; returns float32 (noisy conductances
    are not integers, so they are never cast back). ``shape`` is the
    layout the noise is drawn over when it differs from ``digits.shape``
    with the same element count (the 6-D conv layout of flattened
    planes)."""
    d = digits.to(torch.float32)
    if not variation_wanted(variation, sigma):
        return d
    noise = variation_noise(variation, shape or d.shape, sigma,
                            device=d.device)
    return d * noise.reshape(d.shape)


def perturb_packed(packed: Dict[str, torch.Tensor], variation, sigma, *,
                   sample: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One Monte-Carlo device realization of a packed layer: a new dict
    whose ``w_digits`` are float32 logical planes carrying the noise;
    scales, metadata and the ``w_occ`` map pass through (multiplicative
    noise keeps dead cells dead). Nibble planes are unpacked first, so a
    nibble and a dense pack perturb the same cell with the same theta.
    ``sample`` selects the sampler's Monte-Carlo sample."""
    if sample is not None:
        if not isinstance(variation, Sampler):
            raise TypeError("perturb_packed: `sample` selects a Sampler's "
                            "Monte-Carlo sample; a theta tensor is one "
                            "realization already")
        variation = variation.at(sample)
    out = dict(packed)
    d = packed["w_digits"]
    if is_nibble_packed(d):
        d = unpack_nibbles(d)
    out["w_digits"] = perturb_digits(d, variation, sigma)
    return out
