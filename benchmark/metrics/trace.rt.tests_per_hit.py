"""Σ response evaluations ÷ Σ hits blended over every ray-traced frame:
the program's `rt_tests` (4 a leaf a walk enters) and `rt_hits` counters
on `rt.trace`, what the multi-pass walk evaluates again and again for
each hit it keeps. Items are the program's roots, `render.frame`,
recorded while the traced stretch's profiler records; None where it
recorded none."""

from benchmark import program_trace


def read(run):
    tests = program_trace.counter_sum("rt_tests")
    hits = program_trace.counter_sum("rt_hits")
    if tests is None or not hits[0]:
        return None
    return tests[0] / hits[0]
