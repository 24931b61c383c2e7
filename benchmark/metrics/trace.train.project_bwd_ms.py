"""Device ms a training step of the program's `train.project_bwd` span, on
the thread that runs the backward: from the end of the blend's backward
(`train.blend_bwd`) until the cloud's fields have their gradients, the
autograd of projection and SH (`_project_sh`). Items are the program's
roots, `train.step` (`trainer._step`), recorded while the traced
stretch's profiler records; None where it recorded none or no such span."""

from benchmark import span_cover


def read(run):
    return span_cover.span_ms("train.project_bwd")
