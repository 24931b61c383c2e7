"""Device ms a training step of the program's `train.loss` span, round
`image_loss` in `render_loss_tiled`: L1 and SSIM of the rendered image.
Items are the program's roots, `train.step` (`trainer._step`), recorded
while the traced stretch's profiler records; None where it recorded none
or no such span."""

from benchmark import span_cover


def read(run):
    return span_cover.span_ms("train.loss")
