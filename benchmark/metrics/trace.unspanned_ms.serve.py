"""Device ms a served frame in no leaf span of the program (a span with no
span under it): the root's device ms less its leaves' (`span_cover`).
Items are the program's roots, `serve.frame`
(`ServingRenderer.__call__`), recorded while the traced stretch's
profiler records; None where it recorded none."""

from benchmark import span_cover


def read(run):
    return span_cover.unspanned_ms()
