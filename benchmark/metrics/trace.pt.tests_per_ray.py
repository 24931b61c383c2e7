"""Σ triangle tests ÷ Σ rays that entered the tree over every per-ray
walk of a frame: the program's `tri_tests` and `tri_rays` counters, one
of each a walk of the per-ray tree (`ops/tri_bvh.py`, `csrc/tri_bvh.cu`:
four tests a leaf) in `_closest_hit`, which the path tracer's waves after
bounce 0 take. Items are the program's roots, `pt.frame`, recorded while
the traced stretch's profiler records; None where it recorded none, or
where the program has no per-ray walk."""

from benchmark import program_trace


def read(run):
    tests = program_trace.counter_sum("tri_tests")
    rays = program_trace.counter_sum("tri_rays")
    if tests is None or not rays[0]:
        return None
    return tests[0] / rays[0]
