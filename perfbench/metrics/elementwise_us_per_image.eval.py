"""Device time per image of everything but the CIM conv launches (K3 on
int8 or float planes, with their helpers): activation quantization, BN,
ReLU, residual adds, the stem and FC, the perturbation of the planes
under cell variation, copies."""
UNIT = "us/image"
LAYER = "CIM layer (api/backends.py, core/cim_conv.py, core/variation.py)"
MOVES = "eval_images_per_s"
SOURCE = "device_trace"
K3 = ("cim_mma_kernel", "cim_ordered_sum_kernel", "relayout_digits_kernel",
      "cim_float_kernel", "float_digits_kernel")


def read(run):
    sl = run.slice
    t = sl.device_s(lambda n: not any(k in n for k in K3))
    return 1e6 * t / sl.units
