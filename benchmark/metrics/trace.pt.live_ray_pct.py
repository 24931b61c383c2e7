"""Σ rays active on entering a bounce wave ÷ Σ rays of the waves, in
percent: the program's `live_rays` and `rays` counters, one of each a
wave of `render_path_traced`. Items are the program's roots, `pt.frame`,
recorded while the traced stretch's profiler records; None where it
recorded none."""

from benchmark import program_trace


def read(run):
    live = program_trace.counter_sum("live_rays")
    rays = program_trace.counter_sum("rays")
    if live is None or not rays[0]:
        return None
    return 100.0 * live[0] / rays[0]
