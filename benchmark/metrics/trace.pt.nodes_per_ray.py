"""Σ node records fetched ÷ Σ rays that entered the tree over every
per-ray walk of a frame: the program's `tri_nodes` and `tri_rays`
counters, one of each a walk of the per-ray tree (`ops/tri_bvh.py`,
`csrc/tri_bvh.cu`) in `_closest_hit`, which the path tracer's waves after
bounce 0 take. Items are the program's roots, `pt.frame`, recorded while
the traced stretch's profiler records; None where it recorded none, or
where the program has no per-ray walk."""

from benchmark import program_trace


def read(run):
    nodes = program_trace.counter_sum("tri_nodes")
    rays = program_trace.counter_sum("tri_rays")
    if nodes is None or not rays[0]:
        return None
    return nodes[0] / rays[0]
