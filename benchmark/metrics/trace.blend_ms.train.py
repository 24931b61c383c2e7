"""Device ms a training step of the program's `render.blend` spans, round
the forward blend call (`blend_subtiles` or `blend_tiles`) in
`_TiledBlend.forward`. Items are the program's roots, `train.step`
(`trainer._step`), recorded while the traced stretch's profiler records;
None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("render.blend")
