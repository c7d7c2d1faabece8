"""Execution-backend registry, the single dispatch point for CIM layers
(counterpart of ``repro.api.backends``).

Builtins: ``off`` (full precision), ``emulate`` (fake-quant arithmetic with
materialized partial sums), ``deploy`` (packed planes on the fused CUDA
kernel; ``cfg.use_kernel=False`` takes the plain version) and ``ref``
(packed planes on the plain version, always). The hardware-style backends
``adc_free`` and ``binary`` live in ``repro_torch.backends``, which this
module imports at its end, so their names are valid ``CIMConfig`` modes
as soon as the API is imported.

Backend callables take positional tails, so the dispatch sites stay
uniform (``variation`` is a theta tensor, a ``Sampler`` or None):

  linear(x, params, cfg, variation, sigma, compute_dtype)
  conv(x, params, cfg, stride, padding, variation, sigma, compute_dtype)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.core import cim_conv as _conv
from repro_torch.core import cim_linear as _lin
from repro_torch.core.granularity import ArrayTiling, conv_tiling


@dataclasses.dataclass(frozen=True)
class Backend:
    """One execution strategy for every CIM layer kind. ``packed=True``
    backends consume packed params (``w_digits``); ``pack_linear`` /
    ``pack_conv`` override the standard packers when set; ``plane_bits``
    overrides the (weight_bits, cell_bits) pair of the packed planes'
    geometry (``binary``: S = 1 sign planes)."""

    name: str
    linear: Callable
    conv: Callable
    packed: bool
    description: str = ""
    pack_linear: Optional[Callable] = None
    pack_conv: Optional[Callable] = None
    plane_bits: Optional[Tuple[int, int]] = None


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend, *, replace: bool = False) -> Backend:
    """Register a backend; its name becomes a valid ``CIMConfig.mode``.
    Name collisions raise unless ``replace=True``."""
    if not replace and backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} is already registered; "
                         "pass replace=True to replace it")
    _REGISTRY[backend.name] = backend
    _lin._KNOWN_MODES.add(backend.name)
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown CIM backend {name!r}; registered: "
                       f"{registered_backends()}") from None


def registered_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def is_packed(cfg) -> bool:
    """True when ``cfg``'s backend consumes packed digit planes."""
    if cfg is None or not cfg.enabled:
        return False
    return get_backend(cfg.mode).packed


def packers_for(cfg) -> Tuple[Callable, Callable]:
    """(pack_linear, pack_conv) for ``cfg``'s backend: the standard deploy
    packers unless the backend brings its own (``binary``)."""
    b = get_backend(cfg.mode)
    return (b.pack_linear or _lin._pack_linear,
            b.pack_conv or _conv._pack_conv)


def has_own_pack(cfg) -> bool:
    """True when ``cfg``'s backend packs its own plane format; such planes
    keep dense storage (no nibbles, no occupancy map)."""
    b = get_backend(cfg.mode)
    return b.pack_linear is not None or b.pack_conv is not None


def plane_bits(cfg) -> Tuple[int, int]:
    """(weight_bits, cell_bits) of ``cfg``'s packed digit planes."""
    return get_backend(cfg.mode).plane_bits or (cfg.weight_bits,
                                                cfg.cell_bits)


def plane_tiling(cfg, k: int, n: int) -> ArrayTiling:
    """ArrayTiling of ``cfg``'s packed linear planes, honouring
    ``plane_bits``."""
    wb, cb = plane_bits(cfg)
    return ArrayTiling(k=k, n=n, array_rows=cfg.array_rows,
                       array_cols=cfg.array_cols, weight_bits=wb,
                       cell_bits=cb)


def conv_plane_tiling(cfg, kh: int, kw: int, c_in: int, c_out: int):
    """(ArrayTiling, c_per_array) of ``cfg``'s packed conv planes under the
    stretched-kernel rule, honouring ``plane_bits``."""
    wb, cb = plane_bits(cfg)
    return conv_tiling(kh, kw, c_in, c_out, cfg.array_rows, cfg.array_cols,
                       wb, cb)


def _linear_ref(x, params, cfg, variation, sigma, compute_dtype):
    return _lin._forward_deploy(x, params, cfg.replace(use_kernel=False),
                                variation, sigma, compute_dtype)


def _conv_ref(x, params, cfg, stride, padding, variation, sigma,
              compute_dtype):
    return _conv._forward_conv_deploy(x, params, cfg.replace(use_kernel=False),
                                      stride, padding, variation, sigma,
                                      compute_dtype)


register_backend(Backend(
    name="off", linear=_lin._forward_off, conv=_conv._forward_conv_off,
    packed=False, description="full-precision baseline (no quantization)"))

register_backend(Backend(
    name="emulate", linear=_lin._forward_emulate,
    conv=_conv._forward_conv_emulate, packed=False,
    description="fake-quant path; partial sums materialized"))

register_backend(Backend(
    name="deploy", linear=_lin._forward_deploy,
    conv=_conv._forward_conv_deploy, packed=True,
    description="packed int digit planes on the fused CUDA kernel (plain "
                "PyTorch version when cfg.use_kernel=False or on the CPU)"))

register_backend(Backend(
    name="ref", linear=_linear_ref, conv=_conv_ref, packed=True,
    description="packed int digit planes on the plain PyTorch version"))


# The hardware-style backends register themselves on import; imported last
# so that Backend and register_backend exist when they do.
import repro_torch.backends  # noqa: E402,F401  (registers adc_free, binary)
