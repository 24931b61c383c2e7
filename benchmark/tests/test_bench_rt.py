"""The ray-traced splat cell (`loops/rtview.py`), its readers and its
control (`control_rt.py`): on the CPU at a tiny size (3,000 splats at
96×64) the cell runs correct and the control and the walk-order fault
fail its limits; the `trace.rt.*` readers from the program's counters;
the least time's count. On the card (marker gpu) the control and the
fault fail the limits at the cell's own size, on three seeds, as the
limits were set."""

from __future__ import annotations

import importlib.util
import json

import pytest
import torch

from benchmark import control_rt, harness, rt_roofline, roofline
from benchmark.tests.bench_tiny import make_tiny, run
from gsrt_torch.utils import profiling
from gsrt_torch.utils.profiling import TRACER

CELL = "m360-rt"


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in numbers)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = make_tiny(tmp_path_factory.mktemp("bench"))
    m = root / "benchmark/traffic/orbit-traced.json"
    mix = json.loads(m.read_text())
    mix.update(warm_frames=1, check_pixels=512)
    m.write_text(json.dumps(mix))
    return root


def test_cell_runs_and_is_correct_on_cpu(tiny):
    r = run(tiny, CELL)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"mrays_per_s", "setup_s"}
    assert r["checks"]["hits_mismatch_pct"]["value"] == 0.0


def test_control_and_fault_fail_the_limits_on_cpu(tiny):
    r = control_rt.readings(CELL, 11, "cpu",
                            bench_path=tiny / "BENCHMARK.json",
                            pkg_root=tiny / "benchmark", repo_root=tiny)
    limits = json.loads((tiny / "benchmark/limits" / f"{CELL}.json")
                        .read_text())
    assert _fails(r["control"], limits), r
    assert _fails(r["walk_order"], limits), r
    assert r["walk_order"]["hits_mismatch_pct"] == 0.0


def _reader(name):
    path = harness.PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_of_the_traced_frame(monkeypatch):
    """Per-ray and per-hit ratios of the counters on `rt.trace`, summed
    over the roots; None without roots."""
    names = ("trace.rt.passes_per_ray", "trace.rt.nodes_per_ray",
             "trace.rt.tests_per_hit", "trace.rt.trace_ms",
             "trace.rt.colors_ms")
    TRACER.reset()
    assert all(_reader(n)(None) is None for n in names)
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    for nodes in (300, 500):
        with TRACER.span("render.frame", root=True):
            with TRACER.span("rt.colors"):
                pass
            with TRACER.span("rt.trace"):
                TRACER.count(rt_rays=10, rt_nodes=torch.tensor(nodes),
                             rt_tests=400, rt_passes=30, rt_hits=100)
    got = {n: _reader(n)(None) for n in names}
    TRACER.reset()
    assert got["trace.rt.passes_per_ray"] == pytest.approx(3.0)
    assert got["trace.rt.nodes_per_ray"] == pytest.approx(40.0)
    assert got["trace.rt.tests_per_hit"] == pytest.approx(4.0)
    assert got["trace.rt.trace_ms"] >= 0 and got["trace.rt.colors_ms"] >= 0


def test_least_seconds_of_a_frame():
    """Each blended hit evaluated and blended once, each splat and ray
    read (and written) once."""
    t = rt_roofline.least_seconds(1e9, 3_000_000, 2_000_000)
    assert rt_roofline.HIT_FLOPS == 73
    assert t == pytest.approx(max(
        73e9 / roofline.F32_FLOPS,
        (52 * 3_000_000 + 48 * 2_000_000) / roofline.HBM_BYTES_PER_S))


@pytest.mark.gpu
def test_control_and_fault_fail_the_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    limits = harness.load_json(harness.PKG / "limits" / f"{CELL}.json")
    for seed in (4400000001, 4400000002, 4400000003):
        r = control_rt.readings(CELL, seed, "cuda")
        assert _fails(r["control"], limits), r
        assert _fails(r["walk_order"], limits), r
