"""Device ms a served frame of the program's `serve.cutoff` spans, round
`update_cutoff_map` and the frame's packed scalars in `_serving_step`,
in the frame and in a strict re-render. Items are the program's roots,
`serve.frame` (`ServingRenderer.__call__`), recorded while the traced
stretch's profiler records; None where it recorded none or no such span."""

from benchmark import span_cover


def read(run):
    return span_cover.span_ms("serve.cutoff")
