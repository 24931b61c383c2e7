"""Device ms a frame of the program's `pt.splats` spans: each bounce
wave's splat segment in `render_path_traced` (with a splat tree, one
`csrc/splat_bvh.cu` launch a wave over the wave's rays, windowed at
their surface hits). Items are the program's roots, `pt.frame`
(`render_path_traced_calibrated`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("pt.splats")
