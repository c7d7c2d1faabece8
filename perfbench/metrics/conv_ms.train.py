"""Device ms per QAT step in the convolution library's kernels (cuDNN and
CUTLASS: the emulate grouped conv of the partial sums, forward and both
backward passes, and the stem), matched by these name parts."""
UNIT = "ms"
LAYER = "emulate CIM layer (core/cim_conv.py, core/quantizer.py)"
MOVES = "train_step_ms"
SOURCE = "device_trace"
CONV = ("conv", "cudnn", "xmma", "cutlass", "sgemm", "wgrad", "dgrad",
        "fprop", "implicit", "nchwToNhwc", "nhwcToNchw")


def is_conv(name: str) -> bool:
    return any(p in name for p in CONV)


def read(run):
    sl = run.slice
    return 1e3 * sl.device_s(is_conv) / sl.units
