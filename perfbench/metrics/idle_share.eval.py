"""Share of the traced slice in which no kernel, copy or set ran on the
card: one minus the union of the device's intervals over the slice."""
UNIT = "%"
LAYER = "device"
MOVES = "eval_images_per_s"
SOURCE = "device_trace"


def read(run):
    sl = run.slice
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
