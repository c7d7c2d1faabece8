"""``dispatch_us_per_image.eval``'s reader in the Monte-Carlo variation cells, where it
moves ``mc_images_per_s``."""
from perfbench.harness import metric_module

UNIT = "us/image"
LAYER = "model forward (models/resnet.py forward)"
MOVES = "mc_images_per_s"
SOURCE = "program_span"

read = metric_module("dispatch_us_per_image.eval").read
