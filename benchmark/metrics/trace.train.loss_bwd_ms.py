"""Device ms a training step of the program's `train.loss_bwd` span, on the
thread that runs the backward: from the start of `loss.backward()` until
the blend's outputs have their gradient, the backward of L1 and SSIM.
Items are the program's roots, `train.step` (`trainer._step`), recorded
while the traced stretch's profiler records; None where it recorded none
or no such span."""

from benchmark import span_cover


def read(run):
    return span_cover.span_ms("train.loss_bwd")
