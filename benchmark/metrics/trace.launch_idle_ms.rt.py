"""Device-idle ms a ray-traced frame in the traced stretch's profiler
trace (`run.profile`): the gaps between kernels, copies and fills whose
midpoint lies inside the range of one of the program's layer spans (a
span under a root that is not a `*.sync`; the traced mode has none) and
inside no `*.sync` span. That is idle from the host enqueueing more
slowly than the card runs. Items are the program's roots, `render.frame`
(`GaussianRayTracer.__call__` in "traced" mode), recorded while the
traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.launch_idle_ms(run)
