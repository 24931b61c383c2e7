"""Device ms a frame of the program's `pt.sort` spans: each bounce
wave's coherence permutation, the parking of retired rays and the
un-permute in `render_path_traced`. Items are the program's roots,
`pt.frame` (`render_path_traced_calibrated`), recorded while the traced
stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("pt.sort")
