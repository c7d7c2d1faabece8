"""The whole QAT step's share of the card's highest dense rate: 3 x the
forward's operations (``counts.model_ops_per_image``, forward, and the
backward's two passes) for the slice's steps, over the slice's seconds,
against int8's 1,979 TOP/s."""
from perfbench import counts

UNIT = "%"
LAYER = "QAT step (train/qat.py qat_step)"
MOVES = "train_step_ms"
SOURCE = "device_trace"


def read(run):
    sl = run.slice
    ops = 3 * counts.model_ops_per_image(run.config) * run.traffic["batch"]
    return 100.0 * ops * sl.units / sl.window_s / counts.PEAK_INT8_OPS
