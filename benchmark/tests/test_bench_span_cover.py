"""The readers of the training stages, the serving cutoff map and an
item's remainder (`benchmark/span_cover.py`) on the CPU: made-up reports
where the leaves cover the root and where they leave a gap, and None
without roots or without the span."""

from __future__ import annotations

import pytest

from benchmark import span_cover
from gsrt_torch.utils import profiling
from gsrt_torch.utils.profiling import TRACER


def span(name, parent, root, ms):
    return dict(name=name, parent=parent, root=root, host_ms=ms,
                device_ms=ms, counters={})


@pytest.fixture
def tracer(monkeypatch):
    TRACER.reset()
    yield monkeypatch
    TRACER.reset()


def test_leaves_that_cover_the_root_leave_nothing():
    # root 10 ms: a layer 4 ms, and a span holding two leaves of 3 ms
    rep = [span("train.step", None, 0, 10.0), span("train.loss", 0, 0, 4.0),
           span("train.backward", 0, 0, 6.0),
           span("train.loss_bwd", 2, 0, 3.0),
           span("train.blend_bwd", 2, 0, 3.0)]
    assert span_cover.unspanned(rep) == 0.0


def test_a_gap_between_leaves_is_unspanned():
    # two items; the second's leaves miss 1.5 ms, and a span outside every
    # root counts for neither
    rep = [span("render.frame", None, 0, 3.0),
           span("render.project", 0, 0, 1.0),
           span("render.blend", 0, 0, 2.0),
           span("render.frame", None, 3, 5.0),
           span("render.project", 3, 3, 1.5),
           span("render.blend", 3, 3, 2.0),
           span("stray", None, None, 7.0)]
    assert span_cover.unspanned(rep) == pytest.approx(1.5)
    # a root with no span under it is unspanned whole
    assert span_cover.unspanned([span("serve.frame", None, 0, 2.5)]) == 2.5


def test_readers_find_nothing_without_roots_or_the_span(tracer):
    assert span_cover.unspanned_ms() is None
    assert span_cover.span_ms("serve.cutoff") is None
    tracer.setattr(profiling, "_profiling", lambda: True)
    with TRACER.span("serve.cutoff"):      # outside every root
        pass
    assert span_cover.unspanned_ms() is None
    assert span_cover.span_ms("serve.cutoff") is None
    for _ in range(2):
        with TRACER.span("serve.frame", root=True):
            with TRACER.span("render.blend"):
                pass
    rep = TRACER.report()
    assert span_cover.span_ms("serve.cutoff") is None   # no such span
    assert span_cover.span_ms("render.blend") == pytest.approx(
        sum(s["device_ms"] for s in rep if s["name"] == "render.blend") / 2)
    assert span_cover.unspanned_ms() == pytest.approx(
        span_cover.unspanned(rep) / 2)
