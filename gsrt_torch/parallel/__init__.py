"""Sharded rendering across devices and processes (counterpart of
`gsrt.parallel`): `tiles` on one process's devices, `multihost` across
processes on torch.distributed."""

from gsrt_torch.parallel.tiles import (  # noqa: F401
    calibrate_sharded,
    make_render_mesh,
    render_data_parallel,
    render_splat_sharded,
    tiled_render_fn,
)
