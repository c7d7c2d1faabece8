"""K3 on the int8 tensor cores (``kernels/cim_conv.py::cim_conv_cuda`` ->
``cim_conv_mma_implicit_launch``, the core ``csrc/cim_mma.cuh``): the
least time the traced forwards' CIM conv launches could take
(``counts.k3_bound_s``: per launch the larger of 2 S MACs over 1,979
TOP/s and its bytes over 3.35 TB/s) over their device time, the
wrapper's helper launches included. Silent unless the slice holds one
launch per CIM conv of each forward."""
from perfbench import counts

UNIT = "%"
LAYER = "kernels (kernels/cim_conv.py, csrc/cim_mma.cuh, csrc/cim_matmul.cu)"
MOVES = "eval_images_per_s"
SOURCE = "device_trace"
#: the launch of each conv, then the helpers the wrapper may launch
LAUNCH = "cim_mma_kernel"
KERNELS = (LAUNCH, "cim_ordered_sum_kernel", "relayout_digits_kernel")


def read(run):
    sl, batch = run.slice, run.traffic["batch"]
    forwards = sl.units // batch
    launches = sl.count(lambda n: LAUNCH in n)
    if launches != forwards * len(counts.cim_convs(run.config)):
        return None
    t = sl.device_s(lambda n: any(k in n for k in KERNELS))
    bound = forwards * counts.k3_bound_s(run.config, batch,
                                         float_planes=False)
    return 100.0 * bound / t
