"""Σ pairs the binnings found (each `build_tile_binning`'s `total_pairs`,
before the clamp) ÷ Σ the pair buffers they were sized to (`max_pairs`),
in percent: the program's `pairs` and `max_pairs` counters on its
`render.binning` spans. Items are the program's roots, `render.frame`
(`GaussianRayTracer.__call__`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.pair_fill_pct()
