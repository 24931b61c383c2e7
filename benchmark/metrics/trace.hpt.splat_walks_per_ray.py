"""Σ walks of the splat tree from its root ÷ Σ live rays over every splat
segment of the path-traced frames: the program's `splat_walks` (a walk
fills a 32-entry buffer that serves several k = 8 passes; retired rays,
whose windows are empty, make none) and `splat_rays` counters on
`pt.splats`. Items are the program's roots, `pt.frame`, recorded while
the traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    walks = program_trace.counter_sum("splat_walks")
    rays = program_trace.counter_sum("splat_rays")
    if walks is None or not rays[0]:
        return None
    return walks[0] / rays[0]
