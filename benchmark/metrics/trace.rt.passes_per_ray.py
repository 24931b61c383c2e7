"""Σ passes walked ÷ Σ rays over every ray-traced frame: the program's
`rt_passes` (each a walk of the per-ray tree from its root, a ray's last,
empty one included) and `rt_rays` counters on `rt.trace`. Items are the
program's roots, `render.frame`, recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    passes = program_trace.counter_sum("rt_passes")
    rays = program_trace.counter_sum("rt_rays")
    if passes is None or not rays[0]:
        return None
    return passes[0] / rays[0]
