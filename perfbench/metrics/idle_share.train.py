"""Share of the traced slice of QAT steps in which no kernel, copy or set
ran on the card: one minus the union of the device's intervals over the
slice."""
UNIT = "%"
LAYER = "device"
MOVES = "train_step_ms"
SOURCE = "device_trace"


def read(run):
    sl = run.slice
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
