"""Device ms a training step of the program's `train.blend_bwd` span, round
the whole of `_TiledBlend.backward`: the pixel state,
`splat_grad.blend_backward` and `route_pair_grads`. Items are the
program's `train.step` roots, recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("train.blend_bwd")
