"""Device ms a training step of the program's `train.activate_bwd` span, on
the thread that runs the backward: from the cloud's fields' gradients
until the five leaves have theirs, the backward of
`quat_scale_to_cov3d`, `exp` and `sigmoid`. Items are the program's
roots, `train.step` (`trainer._step`), recorded while the traced
stretch's profiler records; None where it recorded none or no such span."""

from benchmark import span_cover


def read(run):
    return span_cover.span_ms("train.activate_bwd")
