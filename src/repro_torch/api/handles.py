"""Typed layer handles (counterpart of ``repro.api.handles``): one
lifecycle for every CIM layer,

    handle = QuantLinear(k, n, cfg).init(seed)    # trainable emulate params
    handle.calibrate(x)                           # one-batch s_a/s_p init
    y = handle(x, variation=Variation(theta, s))  # forward on cfg's backend
    artifact = handle.pack()                      # saveable DeployArtifact
    served = QuantLinear.from_artifact(artifact)  # packed, deploy backend

Handles are thin mutable conveniences; QAT loops use the functional layer
(``repro_torch.api.linear`` / ``conv2d`` on explicit param dicts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.cim_conv import _calibrate_conv, _conv_forward, _init_conv
from repro_torch.core.cim_linear import (CIMConfig, _calibrate_linear,
                                         _init_linear, _linear_forward)

from .artifact import DeployArtifact, _packed_config
from .backends import get_backend, packers_for


@dataclasses.dataclass(frozen=True)
class Variation:
    """One device realization of log-normal cell noise: ``source`` is a
    theta tensor over the logical packed layout or a ``Sampler``, ``std``
    its sigma (``None`` falls back to ``cfg.variation_std``). With a
    ``DriftState`` as ``std`` it is one drift realization, and ``source``
    a drift source (``core.variation.DriftSource``)."""
    source: object = None
    std: object = None


def _vs(variation: Optional[Variation]):
    if variation is None:
        return None, None
    return variation.source, variation.std


def _generator(gen) -> torch.Generator:
    return torch.Generator().manual_seed(gen) if isinstance(gen, int) else gen


class _Handle:
    """Shared lifecycle plumbing; subclasses bind the layer kind."""

    kind: str

    def __init__(self, cfg: CIMConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.params = params

    def _require_params(self, op: str):
        if self.params is None:
            raise ValueError(f"{type(self).__name__}.{op}: no params — "
                             "call .init(seed) or .from_artifact(...) first")
        return self.params

    def _require_trainable(self, op: str):
        params = self._require_params(op)
        if "w" not in params:
            raise ValueError(
                f"{type(self).__name__}.{op}: params are packed digit "
                "planes (w_digits); this operation needs the trainable "
                "float weights — use the pre-pack handle or .init(seed)")
        return params

    def with_backend(self, mode: str):
        """Same params on another registered backend, which must consume
        the layout this handle holds (packed planes or float weights)."""
        target = get_backend(mode)
        if self.params is not None and self.cfg.enabled:
            have_packed = "w_digits" in self.params
            if target.packed != have_packed:
                have = ("packed digit planes" if have_packed
                        else "trainable float weights")
                need = ("packed digit planes" if target.packed
                        else "trainable float weights")
                raise ValueError(
                    f"backend {mode!r} consumes {need}, but this "
                    f"{type(self).__name__} holds {have}; use .pack() / "
                    ".from_artifact(...) to convert")
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.cfg = self.cfg.replace(mode=mode)
        return clone


class QuantLinear(_Handle):
    """CIM linear layer handle: x (..., K) @ W (K, N) -> (..., N)."""

    kind = "linear"

    def __init__(self, k: int, n: int, cfg: CIMConfig, *,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__(cfg, params)
        self.k, self.n = int(k), int(n)

    def init(self, gen, *, w_init_scale: float | None = None,
             device=None) -> "QuantLinear":
        """Params from ``gen`` (a ``torch.Generator`` or an int seed) on
        ``device`` (``cuda`` unless ``"cpu"``)."""
        self.params = _init_linear(_generator(gen), self.k, self.n, self.cfg,
                                   w_init_scale, device=device)
        return self

    def calibrate(self, x: torch.Tensor) -> "QuantLinear":
        self.params = _calibrate_linear(
            x, self._require_trainable("calibrate"), self.cfg)
        return self

    def __call__(self, x: torch.Tensor, *,
                 variation: Optional[Variation] = None,
                 compute_dtype=torch.float32) -> torch.Tensor:
        source, std = _vs(variation)
        return _linear_forward(x, self._require_params("__call__"), self.cfg,
                               variation=source, variation_std=std,
                               compute_dtype=compute_dtype)

    def pack(self, *, variation: Optional[Variation] = None,
             meta: Optional[Dict] = None) -> DeployArtifact:
        source, std = _vs(variation)
        pack_lin, _ = packers_for(_packed_config(self.cfg))
        packed = pack_lin(self._require_trainable("pack"), self.cfg,
                          variation=source, variation_std=std)
        m = {"k": self.k, "n": self.n, **(meta or {}),
             "col_shard": {"": -1}}
        return DeployArtifact(kind="linear", config=_packed_config(self.cfg),
                              params=packed, meta=m)

    @classmethod
    def from_artifact(cls, artifact: DeployArtifact) -> "QuantLinear":
        if artifact.kind != "linear":
            raise ValueError(f"expected a 'linear' artifact, got "
                             f"{artifact.kind!r}")
        return cls(int(artifact.meta["k"]), int(artifact.meta["n"]),
                   artifact.config, params=artifact.params)


class QuantConv2d(_Handle):
    """CIM conv2d handle: NHWC x, HWIO weight, stretched-kernel tiling."""

    kind = "conv"

    def __init__(self, kh: int, kw: int, c_in: int, c_out: int,
                 cfg: CIMConfig, *, stride: int = 1, padding: str = "SAME",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__(cfg, params)
        self.kh, self.kw = int(kh), int(kw)
        self.c_in, self.c_out = int(c_in), int(c_out)
        self.stride, self.padding = int(stride), padding

    def init(self, gen, *, device=None) -> "QuantConv2d":
        """Params from ``gen`` (a ``torch.Generator`` or an int seed) on
        ``device`` (``cuda`` unless ``"cpu"``)."""
        self.params = _init_conv(_generator(gen), self.kh, self.kw,
                                 self.c_in, self.c_out, self.cfg,
                                 device=device)
        return self

    def calibrate(self, x: torch.Tensor) -> "QuantConv2d":
        self.params = _calibrate_conv(x, self._require_trainable("calibrate"),
                                      self.cfg, stride=self.stride,
                                      padding=self.padding)
        return self

    def __call__(self, x: torch.Tensor, *,
                 variation: Optional[Variation] = None,
                 compute_dtype=torch.float32) -> torch.Tensor:
        source, std = _vs(variation)
        return _conv_forward(x, self._require_params("__call__"), self.cfg,
                             stride=self.stride, padding=self.padding,
                             variation=source, variation_std=std,
                             compute_dtype=compute_dtype)

    def pack(self, *, variation: Optional[Variation] = None,
             meta: Optional[Dict] = None) -> DeployArtifact:
        source, std = _vs(variation)
        _, pack_cv = packers_for(_packed_config(self.cfg))
        packed = pack_cv(self._require_trainable("pack"), self.cfg,
                         variation=source, variation_std=std)
        m = {"kh": self.kh, "kw": self.kw, "c_in": self.c_in,
             "c_out": self.c_out, "stride": self.stride,
             "padding": self.padding, **(meta or {}),
             "col_shard": {"": -1}}
        return DeployArtifact(kind="conv", config=_packed_config(self.cfg),
                              params=packed, meta=m)

    @classmethod
    def from_artifact(cls, artifact: DeployArtifact) -> "QuantConv2d":
        if artifact.kind != "conv":
            raise ValueError(f"expected a 'conv' artifact, got "
                             f"{artifact.kind!r}")
        m = artifact.meta
        return cls(int(m["kh"]), int(m["kw"]), int(m["c_in"]),
                   int(m["c_out"]), artifact.config,
                   stride=int(m.get("stride", 1)),
                   padding=m.get("padding", "SAME"),
                   params=artifact.params)
