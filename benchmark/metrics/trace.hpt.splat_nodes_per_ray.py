"""Σ node records fetched ÷ Σ live rays over every splat segment of the
path-traced frames: the program's `splat_nodes` (the splat tree kernel's
walks, all passes) and `splat_rays` (the rays live on entering a
segment) counters on `pt.splats`. Items are the program's roots,
`pt.frame`, recorded while the traced stretch's profiler records; None
where it recorded none."""

from benchmark import program_trace


def read(run):
    nodes = program_trace.counter_sum("splat_nodes")
    rays = program_trace.counter_sum("splat_rays")
    if nodes is None or not rays[0]:
        return None
    return nodes[0] / rays[0]
