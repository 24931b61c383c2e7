"""New device allocations of the caching allocator a served frame: the
program's `device_allocs` counter, the change of `num_device_alloc` in
`torch.cuda.memory_stats` over each root span. Items are the program's
roots, `serve.frame` (`ServingRenderer.__call__`), recorded while the
traced stretch's profiler records; None where it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.device_allocs()
