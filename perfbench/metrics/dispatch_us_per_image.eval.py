"""Host time enqueuing one batch's forward (the benchmark's span around
``resnet.forward`` and the predictions' copy), per image, averaged over
the window's batches outside the profiled slice."""
UNIT = "us/image"
LAYER = "model forward (models/resnet.py forward)"
MOVES = "eval_images_per_s"
SOURCE = "program_span"


def read(run):
    spans = run.spans["dispatch_s"]
    if not spans:
        return None
    return 1e6 * sum(spans) / len(spans) / run.spans["unit"]
