"""The whole eval forward's share of the card's highest dense rate: the
model's operations counted from shapes (``counts.model_ops_per_image``:
2 S MACs of every CIM conv over real rows, 2 MACs of the stem and FC)
for the traced slice's images, over the slice's seconds, against int8's
1,979 TOP/s, so no implementation can read over 100 %."""
from perfbench import counts

UNIT = "%"
LAYER = "model forward (models/resnet.py forward)"
MOVES = "eval_images_per_s"
SOURCE = "device_trace"


def read(run):
    sl = run.slice
    ops = counts.model_ops_per_image(run.config) * sl.units
    return 100.0 * ops / sl.window_s / counts.PEAK_INT8_OPS
