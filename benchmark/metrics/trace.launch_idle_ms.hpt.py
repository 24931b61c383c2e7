"""Device-idle ms a path-traced hybrid frame in the traced stretch's
profiler trace (`run.profile`): the gaps between kernels, copies and
fills whose midpoint lies inside the range of one of the program's layer
spans (a span under a root that is not a `*.sync`: `pt.colors`,
`pt.primary`, `pt.traverse`, `pt.splats`, `pt.sort`, `pt.shade`) and
inside no `*.sync` span. That is idle from the host enqueueing more
slowly than the card runs, which the small waves late in a path show.
Items are the program's roots, `pt.frame`
(`render_path_traced_calibrated`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.launch_idle_ms(run)
