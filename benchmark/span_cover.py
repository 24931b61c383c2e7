"""What the readers of the training stages, the serving cutoff map and
the item's remainder (`trace.unspanned_ms.*`) share.

An item is one root span of the program's tracer (`program_trace`). Its
leaves are the spans under it that have no span under them. The leaves
of one item run one after another on one stream, so the device ms of the
root that lies in no leaf is the root's device ms less the sum of its
leaves'. What is left is work and idle the program's spans do not name:
ops launched in the root between its layers, and the host's own time
between one leaf's end and the next one's start, the tracer's included.
"""

from __future__ import annotations

from benchmark import program_trace


def span_ms(name: str):
    """`program_trace.span_ms(name)`, or None where no item holds a span
    named `name` (a program from before the span)."""
    got = program_trace.spans()
    if got is None or not any(s["name"] == name and s["root"] is not None
                              for s in got[0]):
        return None
    return program_trace.span_ms(name)


def unspanned(report) -> float:
    """Σ over the roots of `report` of device ms in no leaf span."""
    parents = {s["parent"] for s in report}
    total = 0.0
    for i, s in enumerate(report):
        if s["root"] == i:
            total += s["device_ms"]
        elif s["root"] is not None and i not in parents:
            total -= s["device_ms"]
    return total


def unspanned_ms():
    """Device ms an item of its roots in no leaf span, or None."""
    got = program_trace.spans()
    if got is None:
        return None
    report, roots = got
    return unspanned(report) / roots
