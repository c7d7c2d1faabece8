"""The ``adc_free`` hardware style (counterpart of
``repro.backends.adc_free``): digital accumulation, no ADC.

Each bit-sliced (split, array tile, column) partial sum leaves the array
exact and is accumulated digitally, so the psum quantization the paper's
column-wise s_p exists to tame disappears. ``cfg.psum_bits``,
``cfg.psum_quant`` and the packed ``s_p`` are carried but not read. The
style consumes the standard deploy pack, so one packed tree serves on
``deploy``, ``ref`` and ``adc_free``, and runs it on the ADC-free kernels
(``kernels/cim_adc_free.py``). On clean planes it equals ``emulate`` with
``psum_quant=False`` bit for bit; cell variation applies as on deploy.
"""
from __future__ import annotations

from repro_torch.api.backends import Backend, register_backend
from repro_torch.core.cim_conv import _forward_conv_deploy
from repro_torch.core.cim_linear import _forward_deploy


def _linear_adc_free(x, params, cfg, variation, sigma, compute_dtype):
    return _forward_deploy(x, params, cfg, variation, sigma, compute_dtype,
                           adc_free=True)


def _conv_adc_free(x, params, cfg, stride, padding, variation, sigma,
                   compute_dtype):
    return _forward_conv_deploy(x, params, cfg, stride, padding, variation,
                                sigma, compute_dtype, adc_free=True)


ADC_FREE = register_backend(Backend(
    name="adc_free", linear=_linear_adc_free, conv=_conv_adc_free,
    packed=True,
    description="ADC-free CIM: exact digital accumulation of bit-sliced "
                "partial sums (no psum quantization); consumes the "
                "standard deploy pack"))
