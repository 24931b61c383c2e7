"""Σ response evaluations ÷ Σ hits blended over every splat segment of
the path-traced frames: the program's `splat_tests` (4 a leaf a walk
enters) and `splat_hits` counters on `pt.splats`, what the walks
evaluate for each hit kept. Items are the program's roots, `pt.frame`,
recorded while the traced stretch's profiler records; None where it
recorded none."""

from benchmark import program_trace


def read(run):
    tests = program_trace.counter_sum("splat_tests")
    hits = program_trace.counter_sum("splat_hits")
    if tests is None or not hits[0]:
        return None
    return tests[0] / hits[0]
