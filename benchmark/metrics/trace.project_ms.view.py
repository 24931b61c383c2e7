"""Device ms a frame of the program's `render.project` spans:
`render_tiled`'s `_precompute`, `screen_extents_abc` and `alive_mask`,
everything before the binning (two CUDA events on the current stream).
Items are the program's roots, `render.frame`
(`GaussianRayTracer.__call__`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("render.project")
