"""Mean device milliseconds a step between CUDA events round the Adam
instance's `step` (loops/train.py's object span)."""


def read(run):
    return run.span_ms_per_item("optim")
