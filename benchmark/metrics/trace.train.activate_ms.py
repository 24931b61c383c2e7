"""Device ms a training step of the program's `train.activate` span, round
`GaussianParams.to_cloud` in `render_loss_tiled`: the activations (`exp`
of the scales, `quat_scale_to_cov3d`, `sigmoid` of the opacity). Items
are the program's roots, `train.step` (`trainer._step`), recorded while
the traced stretch's profiler records; None where it recorded none or no
such span."""

from benchmark import span_cover


def read(run):
    return span_cover.span_ms("train.activate")
