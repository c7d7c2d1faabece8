"""K3 on float32 planes (cell variation) on the FP64 tensor cores
(``kernels/cim_conv.py::implicit_conv`` -> ``cim_conv_float_implicit_launch``
in ``csrc/cim_matmul.cu``): the least time the traced forwards' CIM conv
launches could take (``counts.k3_bound_s`` with float planes: per launch
the larger of 2 S MACs over FP64 tensor's 67 TFLOP/s, the rate the
exactness contract allows, and its bytes over 3.35 TB/s) over their
device time, the wrapper's float64 digit pass included. Silent unless the
slice holds one launch per CIM conv of each forward."""
from perfbench import counts

UNIT = "%"
LAYER = "kernels (kernels/cim_conv.py, csrc/cim_mma.cuh, csrc/cim_matmul.cu)"
MOVES = "mc_images_per_s"
SOURCE = "device_trace"
LAUNCH = "cim_float_kernel"
KERNELS = (LAUNCH, "float_digits_kernel")


def read(run):
    sl, batch = run.slice, run.traffic["batch"]
    forwards = sl.units // batch
    launches = sl.count(lambda n: LAUNCH in n)
    if launches != forwards * len(counts.cim_convs(run.config)):
        return None
    t = sl.device_s(lambda n: any(k in n for k in KERNELS))
    bound = forwards * counts.k3_bound_s(run.config, batch, float_planes=True)
    return 100.0 * bound / t
