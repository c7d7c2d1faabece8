"""Host time enqueuing one QAT step (the benchmark's span around
``train.qat.qat_step``), averaged over the window's steps outside the
profiled slice."""
UNIT = "ms"
LAYER = "QAT step (train/qat.py qat_step)"
MOVES = "train_step_ms"
SOURCE = "program_span"


def read(run):
    spans = run.spans["dispatch_s"]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
