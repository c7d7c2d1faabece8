"""``idle_share.eval``'s reader in the Monte-Carlo variation cells, where it
moves ``mc_images_per_s``."""
from perfbench.harness import metric_module

UNIT = "%"
LAYER = "device"
MOVES = "mc_images_per_s"
SOURCE = "device_trace"

read = metric_module("idle_share.eval").read
