"""The path-tracing cell (`loops/pt.py`) and its control
(`control_pt.py`): on the CPU at a tiny size (2,000 triangles, 48×32, 3
bounces) the cell runs correct and the control and the dropped bounce
fail its limits; on the card (marker gpu) the control and the fault fail
them at the cell's own size, on three seeds, as the limits were set."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import control_pt, harness
from benchmark.tests.bench_tiny import make_tiny, run

CELL = "bathroom-pt"


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in numbers)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = make_tiny(tmp_path_factory.mktemp("bench"))
    p = root / "benchmark/configs/bathroom-pt-1080p.json"
    d = json.loads(p.read_text())
    d.update(triangles=2000, bounces=3,
             frame=dict(width=48, height=32, samples_per_pixel=1))
    p.write_text(json.dumps(d))
    m = root / "benchmark/traffic/pt-still.json"
    mix = json.loads(m.read_text())
    mix.update(warm_frames=1, check_pixels=512)
    m.write_text(json.dumps(mix))
    return root


def test_cell_runs_and_is_correct_on_cpu(tiny):
    r = run(tiny, CELL)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"mrays_per_s", "setup_s"}


def test_control_and_fault_fail_the_limits_on_cpu(tiny):
    r = control_pt.readings(CELL, 11, "cpu",
                            bench_path=tiny / "BENCHMARK.json",
                            pkg_root=tiny / "benchmark", repo_root=tiny)
    limits = json.loads((tiny / "benchmark/limits" / f"{CELL}.json")
                        .read_text())
    assert _fails(r["control"], limits), r
    assert _fails(r["last_bounce_dropped"], limits), r


@pytest.mark.gpu
def test_control_and_fault_fail_the_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    limits = harness.load_json(harness.PKG / "limits" / f"{CELL}.json")
    for seed in (4300000001, 4300000002, 4300000003):
        r = control_pt.readings(CELL, seed, "cuda")
        assert _fails(r["control"], limits), r
        assert _fails(r["last_bounce_dropped"], limits), r
