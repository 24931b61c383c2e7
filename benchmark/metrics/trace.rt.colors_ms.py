"""Device ms a frame of the program's `rt.colors` spans: the SH colours
of every splat seen from the eye of a ray-traced frame (`ops/sh.py`
`eval_sh`). Items are the program's roots, `render.frame`, recorded
while the traced stretch's profiler records; None where it recorded
none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("rt.colors")
