"""Device ms a frame of the program's `render.binning` spans, round
`render_tiled`'s `build_tile_binning` call. Items are the program's
roots, `render.frame` (`GaussianRayTracer.__call__`), recorded while the
traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("render.binning")
