"""The `trace.*` readers (`benchmark/program_trace.py`) on the CPU: None
without roots, per-item sums of the program's spans and counters with
them, and launch idle from a made-up profiler trace."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, program_trace
from gsrt_torch.utils import profiling
from gsrt_torch.utils.profiling import TRACER


@pytest.fixture
def tracer(monkeypatch):
    TRACER.reset()
    yield monkeypatch
    TRACER.reset()


def test_readers_find_nothing_without_roots(tracer):
    run = harness.Run(loop=None, profile=harness.Trace(
        window_s=1.0, device=[(0.0, 1.0, "k")]))
    assert program_trace.spans() is None
    assert program_trace.span_ms("render.blend") is None
    assert program_trace.launch_idle_ms(run) is None
    tracer.setattr(profiling, "_profiling", lambda: True)
    with TRACER.span("render.blend"):      # outside every root
        pass
    for value in (program_trace.span_ms("render.blend"),
                  program_trace.host_wait_ms(),
                  program_trace.pair_fill_pct(),
                  program_trace.device_allocs(),
                  program_trace.launch_idle_ms(run)):
        assert value is None


def test_readers_sum_an_item(tracer):
    tracer.setattr(profiling, "_profiling", lambda: True)
    for pairs in (30, 50):
        with TRACER.span("render.frame", root=True):
            with TRACER.span("render.binning"):
                TRACER.count(pairs=torch.tensor(pairs), max_pairs=100)
            with TRACER.span("render.sync"):
                pass
    rep = TRACER.report()
    ms = lambda name, key="device_ms": sum(s[key] for s in rep
                                           if s["name"] == name) / 2
    assert program_trace.span_ms("render.binning") == ms("render.binning")
    assert program_trace.span_ms("render.blend") == 0.0
    assert program_trace.host_wait_ms() == ms("render.sync", "host_ms")
    assert program_trace.pair_fill_pct() == pytest.approx(40.0)
    assert program_trace.device_allocs() == 0.0

    # µs: a root [0, 100) with a layer span [0, 60) and a sync [60, 70);
    # kernels leave gaps at 20-30 (under the layer), 62-68 (under the
    # sync), 80-90 (under the root alone) and 100-110 (past the second
    # root's layer span)
    host = [(0, 100, "render.frame"), (0, 60, "render.binning"),
            (60, 70, "render.sync"), (100, 200, "render.frame"),
            (100, 104, "render.binning")]
    device = [(0, 20, "k"), (30, 62, "k"), (68, 80, "k"), (90, 100, "k"),
              (110, 120, "k")]
    run = harness.Run(loop=None, profile=harness.Trace(
        window_s=200e-6, device=device, host=host))
    assert program_trace.launch_idle_ms(run) == pytest.approx(10e-3 / 2)
