"""Σ node records fetched ÷ Σ rays over every ray-traced frame: the
program's `rt_nodes` and `rt_rays` counters on `rt.trace` (the walks of
`csrc/splat_bvh.cu`, all passes). Items are the program's roots,
`render.frame`, recorded while the traced stretch's profiler records;
None where it recorded none."""

from benchmark import program_trace


def read(run):
    nodes = program_trace.counter_sum("rt_nodes")
    rays = program_trace.counter_sum("rt_rays")
    if nodes is None or not rays[0]:
        return None
    return nodes[0] / rays[0]
