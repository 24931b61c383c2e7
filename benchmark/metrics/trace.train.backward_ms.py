"""Device ms a training step of the program's `train.backward` span, round
`loss.backward()` in `trainer._step`: the autograd of the loss, the
blend's backward and projection and SH. Items are the program's
`train.step` roots, recorded while the traced stretch's profiler
records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("train.backward")
