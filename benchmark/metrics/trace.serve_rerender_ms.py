"""Device ms a served frame of the program's `serve.rerender` spans: strict
serving's cull-free re-render of a frame whose cull lost content
(`ServingRenderer.__call__`). Items are the program's `serve.frame`
roots, recorded while the traced stretch's profiler records; None where
it recorded none."""

from benchmark import program_trace


def read(run):
    return program_trace.span_ms("serve.rerender")
