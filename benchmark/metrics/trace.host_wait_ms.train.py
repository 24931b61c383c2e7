"""Host ms a training step of the program's spans round a blocking read of
the device (`train.sync`, round `bool(binning.overflow)` in
`_TiledBlend.forward`): the time the host waits for the card. Items are
the program's roots, `train.step` (`trainer._step`), recorded while the
traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.host_wait_ms()
