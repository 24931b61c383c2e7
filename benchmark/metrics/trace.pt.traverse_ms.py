"""Device ms a frame of the program's `pt.traverse` spans: the hit
search of bounces 1 and later in `render_path_traced` (`plan_visits` and
the traversal kernel, `csrc/tri_kernel.cu`). Items are the program's
roots, `pt.frame` (`render_path_traced_calibrated`), recorded while the
traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("pt.traverse")
