"""New device allocations of the caching allocator a ray-traced frame: the
program's `device_allocs` counter, the change of `num_device_alloc` in
`torch.cuda.memory_stats` over each root span. Items are the program's
roots, `render.frame` (`GaussianRayTracer.__call__` in "traced" mode),
recorded while the traced stretch's profiler records; None where it
recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.device_allocs()
