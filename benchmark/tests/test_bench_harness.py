"""The harness on the CPU: its arithmetic, the module check, a cell, a
mix and a metric added as files only, and each fault a cell can have
turning `correct` false."""

from __future__ import annotations

import json
import statistics

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.bench_tiny import make_tiny, run


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_matches_numpy(q):
    v = list(np.random.default_rng(3).exponential(size=257))
    assert harness.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_union_and_gaps_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert harness.union_seconds(iv) == pytest.approx(3 + 1 + 1)
    assert harness.gaps(iv) == [(3, 5), (6, 8)]
    tr = harness.Trace(window_s=10e-6,
                       device=[(s, e, "k") for s, e in iv])
    assert tr.busy_s == pytest.approx(5e-6)
    assert tr.kernel_seconds("k") == pytest.approx(6.2e-6)
    assert [g[1] for g in tr.idle_gaps()] == pytest.approx([2e-6, 2e-6])


def test_spread_statistic_is_pythons_quartiles():
    # the bound's spread: IQR by statistics.quantiles over the median
    v = [100.0, 101.0, 99.0, 100.5, 98.0, 102.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert (q3 - q1) / statistics.median(v) > 0


@pytest.mark.parametrize("names,bad", [
    (["gsrt_torch", "gsrt_torch.ops.sh", "benchmark.harness"], []),
    (["gsrt", "gsrt_torch"], ["gsrt"]),
    (["gsrt.ops.sh"], ["gsrt.ops.sh"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax.linen", "jax.numpy",
                                              "jaxlib"]),
    (["jaxtyping", "gsrtx"], []),
])
def test_module_check_compares_top_level_names_whole(names, bad):
    assert harness.offending_modules(names) == bad


@pytest.mark.parametrize("workload", ["m360-view", "m360-serve",
                                      "tandt-train"])
def test_cell_runs_and_is_correct_on_cpu(tiny, workload):
    r = run(tiny, workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.metrics_for(bench, "end_to_end",
                                                   workload)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_traced_cell_reports_its_span_metrics(tiny):
    r = run(tiny, "m360-view", trace=True)
    # the device-trace readers find nothing on the CPU and are left out
    assert set(r["metrics"]) == {"project_ms.frame", "binning_ms.frame",
                                 "blend_ms.frame"}


def test_addition_needs_only_new_files(tiny):
    """A configuration, a mix, a cell and a metric added as files and
    entries: the harness finds each by name."""
    root = tiny
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/mipnerf360-1080p.json")
                     .read_text())
    cfg.update(name="extra-cloud", splats=2000, width=64, height=48)
    (root / "benchmark/configs/extra-cloud.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/orbit-fresh.json")
                     .read_text())
    mix.update(views=3, orbit=dict(mix["orbit"], radius=12.0))
    (root / "benchmark/traffic/extra-mix.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/extra-cell.json").write_text(
        (root / "benchmark/limits/m360-view.json").read_text())
    (root / "benchmark/metrics/frames_done.py").write_text(
        "def read(run):\n    return float(len(run.completed))\n")
    bench["configs"].append(dict(name="extra-cloud", source="test",
                                 file="benchmark/configs/extra-cloud.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="extra-cell", config="extra-cloud",
                                   traffic="extra-mix", chips=1, why="t"))
    bench["end_to_end"].append(dict(name="frames_done", unit="frames",
                                    better="higher", bound=0.1,
                                    source="host_clock",
                                    workloads=["extra-cell"]))
    bench["end_to_end"][0]["workloads"].append("extra-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(root, "extra-cell")
    assert r["correct"]
    assert r["metrics"]["frames_done"]["value"] == r["attempted"]
    assert "mrays_per_s" in r["metrics"]


def _alter_frame(loop):
    """An answer altered where it is produced: one tile of every frame
    the tracer returns is brightened."""
    real_setup = loop.setup

    def setup():
        real_setup()
        tracer = loop.tracer

        def altered(*a, **kw):
            out = type(tracer).__call__(tracer, *a, **kw)
            color = out.color.clone()
            color[:16, :32] += 0.1
            return out._replace(color=color)
        loop.tracer = altered
    loop.setup = setup


def _state_unchanged(loop):
    """A training step that returns its state unchanged."""
    def step(gp, opt, target, cam, cfg, max_pairs, lambda_ssim):
        from gsrt_torch.models.trainer import render_loss_tiled
        with torch.no_grad():
            return render_loss_tiled(gp, target, cam, cfg, max_pairs,
                                     lambda_ssim)
    real_setup = loop.setup

    def setup():
        import gsrt_torch.models.trainer as trainer
        orig = trainer.train_step_tiled
        trainer.train_step_tiled = step
        try:
            real_setup()
        finally:
            trainer.train_step_tiled = orig
    loop.setup = setup


def _half_batch(loop):
    """Half of the batch left out: the loss over the image's top half,
    the mean taken over it."""
    import gsrt_torch.models.trainer as trainer
    real_setup, orig = loop.setup, trainer.image_loss

    def half(img, target, lambda_ssim=0.2):
        h = img.shape[0] // 2
        return orig(img[:h], target[:h], lambda_ssim)

    def setup():
        trainer.image_loss = half
        try:
            real_setup()
        finally:
            trainer.image_loss = orig
    loop.setup = setup


@pytest.mark.parametrize("workload,fault", [
    ("m360-view", _alter_frame),
    ("tandt-train", _state_unchanged),
    ("tandt-train", _half_batch),
])
def test_fault_turns_correct_false(tiny, workload, fault):
    r = run(tiny, workload, patch=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["m360-view", "tandt-train"])
def test_least_seconds_of_traced_items(tiny, workload):
    """The roofline readers' least time, from the reference's count, for
    items as a traced window records them."""
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    cell, cfg = harness.find_cell(bench, workload)
    config = harness.load_json(tiny / cfg["file"])
    mix = harness.load_json(tiny / "benchmark/traffic"
                            / f"{cell['traffic']}.json")
    loop = harness.load_module("loops", mix["loop"],
                               tiny / "benchmark").Loop(config, mix, 3,
                                                        "cpu")
    if mix["loop"] == "train":
        loop.make_inputs()
        item = {"latency_s": 0.01, "view": loop.views[0],
                "params": loop.params0}
    else:
        loop.make_scene()
        loop.make_views()
        item = {"latency_s": 0.01, "view": loop.views[0]}
    one = loop.least_seconds([item])
    assert one > 0
    assert loop.least_seconds([item, item, {"latency_s": None}]) == \
        pytest.approx(2 * one)
