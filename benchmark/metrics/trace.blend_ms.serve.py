"""Device ms a served frame of the program's `render.blend` spans, round
the forward blend call (`blend_packed`, `blend_tiles` or
`blend_subtiles`) in `render_tiled`. Items are the program's roots,
`serve.frame` (`ServingRenderer.__call__`), recorded while the traced
stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("render.blend")
