"""Host ms a frame of the program's spans round a blocking read of the
device (`render.sync`, round `bool(out.overflow)` in
`GaussianRayTracer.__call__`): the time the host waits for the card.
Items are the program's roots, `render.frame`
(`GaussianRayTracer.__call__`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.host_wait_ms()
