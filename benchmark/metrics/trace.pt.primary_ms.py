"""Device ms a frame of the program's `pt.primary` spans: bounce 0's hit
search in `render_path_traced` (the screen-tile binning and the binned
cast, `csrc/tri_cast.cu`, or the block traversal). Items are the
program's roots, `pt.frame` (`render_path_traced_calibrated`), recorded
while the traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("pt.primary")
