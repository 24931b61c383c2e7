"""Host ms a frame of the program's spans round a blocking read of the
device (`pt.sync`, round the flags' read in
`render_path_traced_calibrated`): the time the host waits for the card.
Items are the program's roots, `pt.frame`, recorded while the traced
stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.host_wait_ms()
