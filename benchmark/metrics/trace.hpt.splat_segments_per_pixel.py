"""Σ splat segments ÷ Σ pixels of the path-traced frames: the program's
`splat_rays` counter on `pt.splats` (the rays live on entering each
wave's splat segment, the camera rays among them) over the frames'
pixels, so what the paths add beyond one segment a pixel. Items are the
program's roots, `pt.frame`, recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    rays = program_trace.counter_sum("splat_rays")
    if rays is None or not rays[0]:
        return None
    loop = run.loop
    return rays[0] / (rays[1] * loop.W * loop.H * loop.spp)
