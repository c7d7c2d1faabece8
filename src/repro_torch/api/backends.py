"""Execution-backend registry, the single dispatch point for CIM layers
(counterpart of ``repro.api.backends``).

Builtins: ``off`` (full precision), ``emulate`` (fake-quant arithmetic with
materialized partial sums), ``deploy`` (packed planes on the fused CUDA
kernel; ``cfg.use_kernel=False`` takes the plain version) and ``ref``
(packed planes on the plain version, always). The hardware-style backends
``adc_free`` and ``binary`` come with a later slice.

Backend callables:

  linear(x, params, cfg, compute_dtype)
  conv(x, params, cfg, stride, padding, compute_dtype)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.core import cim_conv as _conv
from repro_torch.core import cim_linear as _lin


@dataclasses.dataclass(frozen=True)
class Backend:
    """One execution strategy for every CIM layer kind. ``packed=True``
    backends consume packed params (``w_digits``); ``pack_linear`` /
    ``pack_conv`` override the standard packers when set."""

    name: str
    linear: Callable
    conv: Callable
    packed: bool
    description: str = ""
    pack_linear: Optional[Callable] = None
    pack_conv: Optional[Callable] = None


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


def packers_for(cfg) -> Tuple[Callable, Callable]:
    """(pack_linear, pack_conv) for ``cfg``'s backend."""
    b = get_backend(cfg.mode)
    return (b.pack_linear or _lin._pack_linear,
            b.pack_conv or _conv._pack_conv)


def _linear_ref(x, params, cfg, compute_dtype):
    return _lin._forward_deploy(x, params, cfg.replace(use_kernel=False),
                                compute_dtype)


def _conv_ref(x, params, cfg, stride, padding, compute_dtype):
    return _conv._forward_conv_deploy(x, params, cfg.replace(use_kernel=False),
                                      stride, padding, compute_dtype)


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
