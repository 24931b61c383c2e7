"""Device-idle ms a served frame in the traced stretch's profiler trace
(`run.profile`): the gaps between kernels, copies and fills whose
midpoint lies inside the range of one of the program's layer spans (a
span under a root that is not a `*.sync`) and inside no `*.sync` span.
That is idle from the host enqueueing more slowly than the card runs.
Items are the program's roots, `serve.frame`
(`ServingRenderer.__call__`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.launch_idle_ms(run)
