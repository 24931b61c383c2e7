"""Device ms a frame of the program's `rt.trace` spans: the k-buffer
passes of a ray-traced frame's rays through the per-ray tree
(`ops/splat_bvh.py`, one `csrc/splat_bvh.cu` launch). Items are the
program's roots, `render.frame` (`GaussianRayTracer.__call__`), recorded
while the traced stretch's profiler records; None where it recorded
none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("rt.trace")
