"""``elementwise_us_per_image.eval``'s reader in the Monte-Carlo variation cells, where it
moves ``mc_images_per_s``."""
from perfbench.harness import metric_module

UNIT = "us/image"
LAYER = "CIM layer (api/backends.py, core/cim_conv.py, core/variation.py)"
MOVES = "mc_images_per_s"
SOURCE = "device_trace"

read = metric_module("elementwise_us_per_image.eval").read
