"""Device ms per QAT step outside the convolution library's kernels
(``conv_ms.train``'s): the LSQ and straight-through passes over the partial
sums, shift-and-add, BN, the optimizer's updates, copies."""
from perfbench.harness import metric_module

UNIT = "ms"
LAYER = "emulate CIM layer (core/cim_conv.py, core/quantizer.py)"
MOVES = "train_step_ms"
SOURCE = "device_trace"

_is_conv = metric_module("conv_ms.train").is_conv


def read(run):
    sl = run.slice
    return 1e3 * sl.device_s(lambda n: not _is_conv(n)) / sl.units
