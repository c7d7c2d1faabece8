"""``eval_mfu``'s reading in the Monte-Carlo variation cells, where it
moves ``mc_images_per_s``: the whole varied forward's operations for the
slice's images over its seconds, against int8's 1,979 TOP/s, the card's
highest dense rate (the float planes run on FP64 tensor cores, at 67
TFLOP/s, so this share stays low by design)."""
from perfbench.harness import metric_module

UNIT = "%"
LAYER = "model forward (models/resnet.py forward)"
MOVES = "mc_images_per_s"
SOURCE = "device_trace"

read = metric_module("eval_mfu").read
