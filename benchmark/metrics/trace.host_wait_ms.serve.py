"""Host ms a served frame of the program's spans round a blocking read of
the device (`serve.sync`, round the strict serving frame's
`scalars.tolist()` and its re-render's `s2.tolist()`): the time the host
waits for the card. Items are the program's roots, `serve.frame`
(`ServingRenderer.__call__`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.host_wait_ms()
