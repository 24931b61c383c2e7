"""Σ planned (block, super-cluster) visits ÷ Σ ray blocks over every
traversal of a frame: the program's `tri_visits` (`plan_visits`' total)
and `tri_blocks` counters, one of each a traversal in `_closest_hit`.
Items are the program's roots, `pt.frame`, recorded while the traced
stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    visits = program_trace.counter_sum("tri_visits")
    blocks = program_trace.counter_sum("tri_blocks")
    if visits is None or not blocks[0]:
        return None
    return visits[0] / blocks[0]
