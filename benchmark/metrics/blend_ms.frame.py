"""Mean device milliseconds a frame between CUDA events put round the
port's `blend` layer from the benchmark (harness.Spans, labels from
frames.FrameLoop.SPANS)."""


def read(run):
    return run.span_ms_per_item("blend")
