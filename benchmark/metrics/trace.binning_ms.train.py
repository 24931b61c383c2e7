"""Device ms a training step of the program's `render.binning` spans, round
`_TiledBlend.forward`'s `build_tile_binning` call. Items are the
program's roots, `train.step` (`trainer._step`), recorded while the
traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("render.binning")
