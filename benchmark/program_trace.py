"""What the `trace.*` readers share: the spans and counters the program
records itself (`gsrt_torch.utils.profiling.TRACER`) while the traced
stretch's profiler records, so over the same items as `run.profile`.

An item is one root span: `render.frame` (`GaussianRayTracer.__call__`),
`serve.frame` (`ServingRenderer.__call__`) or `train.step`
(`trainer._step`). Every helper returns None where the program has no
tracer or its tracer recorded no root: a checkout from before the
program traced itself, an untraced run, the CPU (the harness profiles
only on a card).
"""

from __future__ import annotations

import importlib

from benchmark.harness import gaps


def spans():
    """The tracer's report and its number of roots, or None."""
    try:
        prof = importlib.import_module("gsrt_torch.utils.profiling")
    except ImportError:
        return None
    tracer = getattr(prof, "TRACER", None)
    if tracer is None:
        return None
    rep = tracer.report()
    roots = sum(1 for i, s in enumerate(rep) if s["root"] == i)
    return (rep, roots) if roots else None


def per_item(key: str, pick):
    """Σ `key` (`device_ms` or `host_ms`) over the spans inside a root
    whose name `pick` accepts, ÷ the roots."""
    got = spans()
    if got is None:
        return None
    rep, roots = got
    return sum(s[key] for s in rep
               if s["root"] is not None and pick(s["name"])) / roots


def span_ms(name: str):
    """Device ms an item of the spans named `name`."""
    return per_item("device_ms", lambda n: n == name)


def host_wait_ms():
    """Host ms an item of the spans round a blocking read (`*.sync`)."""
    return per_item("host_ms", lambda n: n.endswith(".sync"))


def counter_sum(name: str):
    """Σ counter `name` over the spans inside a root, and the roots."""
    got = spans()
    if got is None:
        return None
    rep, roots = got
    return sum(s["counters"].get(name, 0) for s in rep
               if s["root"] is not None), roots


def pair_fill_pct():
    """Σ pairs binned ÷ Σ the pair buffers they were binned into, %."""
    got = counter_sum("pairs")
    full = counter_sum("max_pairs")
    if got is None or not full[0]:
        return None
    return 100.0 * got[0] / full[0]


def device_allocs():
    """New device allocations of the caching allocator an item."""
    got = counter_sum("device_allocs")
    return None if got is None else got[0] / got[1]


def launch_idle_ms(run):
    """Device-idle ms an item in the traced stretch whose gap's midpoint
    lies inside a layer span (a span under a root, not a `*.sync`) and
    inside no `*.sync` span: the card waited for the host to enqueue."""
    got = spans()
    p = run.profile
    if got is None or p is None or not p.device:
        return None
    rep, roots = got
    inner = {s["name"] for i, s in enumerate(rep)
             if s["root"] is not None and s["root"] != i}
    sync = {n for n in inner if n.endswith(".sync")}
    layer = [(a, b) for a, b, n in p.host if n in inner - sync]
    wait = [(a, b) for a, b, n in p.host if n in sync]
    idle = 0.0
    for s, e in gaps([(a, b) for a, b, _ in p.device]):
        m = 0.5 * (s + e)
        if any(a <= m <= b for a, b in layer) and \
                not any(a <= m <= b for a, b in wait):
            idle += e - s
    return idle * 1e-3 / roots
