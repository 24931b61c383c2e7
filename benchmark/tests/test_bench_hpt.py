"""The hybrid path-tracing cell (`loops/hpt.py`), its readers and its
control (`control_hpt.py`): on the CPU at a tiny size (3,000 splats, two
icospheres at subdivision 1 and the ground, 48×32, 3 bounces) the cell
runs correct and the control and the fault "splats past the surface"
fail its limits; the loop's set-up stops at once on a program whose path
tracer takes no splat tree; the `trace.hpt.*` readers from the program's
counters; the least time's count. On the card (marker gpu) the control
and the fault fail the limits at the cell's own size, on three seeds, as
the limits were set."""

from __future__ import annotations

import importlib.util
import json
import time
import types

import pytest
import torch

from benchmark import control_hpt, harness, rt_roofline
from benchmark.tests.bench_tiny import make_tiny, run
from gsrt_torch.models import path_tracer
from gsrt_torch.utils import profiling
from gsrt_torch.utils.profiling import TRACER

CELL = "m360-hpt"


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in numbers)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = make_tiny(tmp_path_factory.mktemp("bench"))
    p = root / "benchmark/configs/mipnerf360-hybrid-pt-1080p.json"
    d = json.loads(p.read_text())
    d["meshes"]["subdivision"] = 1
    d.update(triangles=2 * 80 + 2, bounces=3,
             frame=dict(width=48, height=32, samples_per_pixel=1))
    p.write_text(json.dumps(d))
    m = root / "benchmark/traffic/orbit-hybrid.json"
    mix = json.loads(m.read_text())
    mix.update(warm_frames=1, check_pixels=512)
    m.write_text(json.dumps(mix))
    return root


def _limits(root):
    return json.loads((root / "benchmark/limits" / f"{CELL}.json")
                      .read_text())


def test_cell_runs_and_is_correct_on_cpu(tiny):
    loops = []
    r = run(tiny, CELL, patch=loops.append)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"mrays_per_s", "setup_s"}
    assert r["checks"]["hits_mismatch_pct"]["value"] == 0.0
    assert r["checks"]["primary_id_mismatch_pct"]["value"] == 0.0
    # the least time of one window frame: the reference's splat hits and
    # segments on the seeded pixels, scaled to the frame
    loop = loops[0]
    rec = {"latency_s": 1.0, "frame_seed": loop.frame_seed(0, 0),
           "view": int(loop.order[0])}
    r = loop.reference(loop.reference_scene(), rec["frame_seed"],
                       rec["view"], loop.pixels(0, 4096, stream=8))
    n = loop.W * loop.H
    splats = int((loop.cloud.opacity > 1 / 255).sum())
    assert loop.least_seconds([rec]) == pytest.approx(
        rt_roofline.least_seconds(
            float(r["splat_hits"].double().mean()) * n, splats,
            float(r["segments"].double().mean()) * n))
    assert float(r["segments"].double().mean()) > 1.0


def test_control_and_fault_fail_the_limits_on_cpu(tiny):
    r = control_hpt.readings(CELL, 11, "cpu",
                             bench_path=tiny / "BENCHMARK.json",
                             pkg_root=tiny / "benchmark", repo_root=tiny)
    limits = _limits(tiny)
    assert _fails(r["control"], limits), r
    assert _fails(r["splats_past_the_surface"], limits), r
    assert r["splats_past_the_surface"]["primary_id_mismatch_pct"] == 0.0


def test_setup_stops_at_once_without_a_splat_tree(tiny, monkeypatch):
    """A program whose render_path_traced takes no gauss_tree (the parent
    of this cell) stops at the start of set-up, before the scene."""
    def old_signature(scene, camera, cfg, seed=0, gaussians=None,
                      primary_ids=None):
        raise AssertionError("never called")
    monkeypatch.setattr(path_tracer, "render_path_traced", old_signature)
    bench = harness.load_json(tiny / "BENCHMARK.json")
    cell, entry = harness.find_cell(bench, CELL)
    config = harness.load_json(tiny / entry["file"])
    mix = harness.load_json(tiny / "benchmark/traffic/orbit-hybrid.json")
    mod = harness.load_module("loops", mix["loop"], tiny / "benchmark")
    loop = mod.Loop(config, mix, 7, "cpu")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="gauss_tree"):
        loop.setup()
    assert time.perf_counter() - t0 < 5.0 and loop.marks == []


def _reader(name):
    path = harness.PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_of_the_traced_frames(monkeypatch):
    """Per-ray, per-hit and per-pixel ratios of the counters on
    `pt.splats`, summed over the roots; the span's ms; None without
    roots."""
    names = ("trace.hpt.splat_ms", "trace.hpt.splat_nodes_per_ray",
             "trace.hpt.splat_walks_per_ray", "trace.hpt.splat_tests_per_hit",
             "trace.hpt.splat_segments_per_pixel")
    run = types.SimpleNamespace(loop=types.SimpleNamespace(W=4, H=5, spp=1))
    TRACER.reset()
    assert all(_reader(n)(run) is None for n in names)
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    for nodes in (300, 500):
        with TRACER.span("pt.frame", root=True):
            for live in (20, 10):
                with TRACER.span("pt.splats"):
                    TRACER.count(splat_rays=torch.tensor(live),
                                 splat_nodes=torch.tensor(nodes),
                                 splat_tests=400, splat_walks=15,
                                 splat_hits=100, splat_replays=5)
    got = {n: _reader(n)(run) for n in names}
    TRACER.reset()
    assert got["trace.hpt.splat_nodes_per_ray"] == pytest.approx(1600 / 60)
    assert got["trace.hpt.splat_walks_per_ray"] == pytest.approx(60 / 60)
    assert got["trace.hpt.splat_tests_per_hit"] == pytest.approx(4.0)
    assert got["trace.hpt.splat_segments_per_pixel"] == pytest.approx(1.5)
    assert got["trace.hpt.splat_ms"] >= 0


@pytest.mark.gpu
def test_control_and_fault_fail_the_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    limits = harness.load_json(harness.PKG / "limits" / f"{CELL}.json")
    for seed in (4500000001, 4500000002, 4500000003):
        r = control_hpt.readings(CELL, seed, "cuda")
        assert _fails(r["control"], limits), r
        assert _fails(r["splats_past_the_surface"], limits), r
