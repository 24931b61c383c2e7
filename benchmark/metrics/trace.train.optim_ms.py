"""Device ms a training step of the program's `train.optim` span, round
`optimizer.step()` in `trainer._step`. Items are the program's
`train.step` roots, recorded while the traced stretch's profiler
records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("train.optim")
