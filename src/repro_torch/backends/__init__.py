"""Alternative CIM hardware styles as backends (counterpart of
``repro.backends``).

Each module registers one style with ``repro_torch.api.backends`` when it
is imported, which ``repro_torch.api.backends`` does at its end, so the
names are valid ``CIMConfig`` modes as soon as the API is imported:

  adc_free  bit-sliced partial sums leave the array exact and are
            accumulated digitally: no per-column ADC, no psum
            quantization. Serves the standard deploy pack on the ADC-free
            kernels (``kernels/cim_adc_free.py``).
  binary    S = 1 sign planes with a per-(array tile, column) mean-|w|
            scale and multi-bit activations, on the deploy kernels
            (``cim_matmul_cuda`` / ``cim_conv_cuda``). Brings its own pack.
"""
from __future__ import annotations

from .adc_free import ADC_FREE
from .binary import (BINARY, binary_calibrate_psum_scale, pack_conv_binary,
                     pack_linear_binary)

__all__ = [
    "ADC_FREE",
    "BINARY",
    "binary_calibrate_psum_scale",
    "pack_conv_binary",
    "pack_linear_binary",
]
