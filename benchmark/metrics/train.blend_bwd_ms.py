"""Mean device milliseconds a step between CUDA events round
`gsrt_torch.ops.splat_grad.blend_backward` (label from loops/train.py)."""


def read(run):
    return run.span_ms_per_item("blend_bwd")
