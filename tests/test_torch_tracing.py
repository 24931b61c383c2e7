"""The program's spans and counters (`gsrt_torch.utils.profiling.TRACER`)
round a tiled frame, a strict serving frame and a tiled training step
(CPU, 32x32 pixels at 16x16 tiles).

Without a profiler nothing is recorded. Under `torch.profiler` each call
records one root and the span tree of its layers, the binning's pair
counters, and a `record_function` range a span, nested in the Chrome
trace as the spans nest; the outputs are bit-equal with tracing on and
off.
"""

from __future__ import annotations

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_env  # noqa: F401
from gsrt_torch import RenderConfig
from gsrt_torch.models import trainer
from gsrt_torch.models.gaussian_rt import GaussianRayTracer
from gsrt_torch.ops import tile_binning
from gsrt_torch.scene.catalog import random_cloud
from gsrt_torch.serving import ServingRenderer
from gsrt_torch.utils import profiling
from gsrt_torch.utils.profiling import TRACER

W = H = 32
MP = 1 << 13
TILES = dict(width=W, height=H, tile_w=16, tile_h=16)
PROJECT_BIN_BLEND = ["render.project", "render.binning", "render.blend"]

BACKWARD_STAGES = ["train.loss_bwd", "train.blend_bwd", "train.project_bwd",
                   "train.activate_bwd"]

# (name, parent's name) of every span an item records, in opening order
TREES = {
    "render": [("render.frame", None)]
    + [(n, "render.frame") for n in ["render.prepare"] + PROJECT_BIN_BLEND
       + ["render.sync"]],
    "serve": [("serve.frame", None)]
    + [(n, "serve.frame") for n in ["render.prepare"] + PROJECT_BIN_BLEND
       + ["serve.cutoff", "serve.sync", "serve.rerender"]]
    + [(n, "serve.rerender") for n in PROJECT_BIN_BLEND
       + ["serve.cutoff", "serve.sync"]],
    "train": [("train.step", None)]
    + [(n, "train.step") for n in ("train.activate", "render.project",
                                   "render.binning", "train.sync",
                                   "render.blend", "train.loss",
                                   "train.backward")]
    + [(n, "train.backward") for n in BACKWARD_STAGES]
    + [("train.optim", "train.step")],
}


@pytest.fixture(autouse=True)
def clean_tracer():
    TRACER.reset()
    yield
    TRACER.reset()


@pytest.fixture(scope="module")
def scene():
    # dense, large splats: every tile saturates, so the serving cull has
    # cutoffs to apply
    return random_cloud(600, seed=7, extent=1.5, scale_range=(0.3, 0.7),
                        width=W, height=H, device="cpu")


def _item(kind: str, scene):
    """A fresh object and the call that makes one item with it: returns
    the tensors the item produced (images; for training the loss and the
    updated parameters)."""
    cloud, cam = scene
    if kind == "render":
        rt = GaussianRayTracer(RenderConfig(**TILES), "tiled", device="cpu")
        rt.calibrate(cloud, cam)

        def call():
            out = rt(cloud, cam)
            return [out.color, out.trans]
        return call
    if kind == "serve":
        cfg = RenderConfig(**TILES, conic_mode="standard",
                           blend_impl="packed", stream="tile",
                           pair_chunk=128, serving_super=2)
        srv = ServingRenderer(cfg, max_pairs=MP, strict=True, device="cpu")
        srv(cloud, cam)         # saturation feedback: the cull goes on

        def call():
            # a map that culls every splat: each tile violates, and the
            # strict frame is rendered again without the cull
            srv.cutoff_map = torch.full_like(srv.cutoff_map, 1e-3)
            out = srv(cloud, cam)
            assert srv.stats[-1]["full_renders"] == 1
            return [out.color, out.trans]
        return call
    params = trainer.init_params(cloud)
    opt = trainer.make_optimizer(params)
    target = torch.linspace(0, 1, H * W * 3).reshape(H, W, 3)

    def call():
        loss = trainer.train_step_tiled(params, opt, target, cam,
                                        RenderConfig(**TILES), MP)
        return [loss] + [p.detach().clone() for p in params.parameters()]
    return call


def _binnings(monkeypatch):
    """Record each build_tile_binning call's (total_pairs, max_pairs)."""
    seen = []
    build = tile_binning.build_tile_binning

    def wrapped(*args, **kw):
        b = build(*args, **kw)
        seen.append((int(b.total_pairs), kw["max_pairs"]))
        return b
    monkeypatch.setattr(tile_binning, "build_tile_binning", wrapped)
    return seen


@pytest.mark.parametrize("kind", ["render", "serve", "train"])
def test_spans_record_only_under_a_profiler(kind, scene, tmp_path,
                                            monkeypatch):
    off = _item(kind, scene)()
    assert TRACER.report() == []
    call = _item(kind, scene)
    seen = _binnings(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = call()
    rep = TRACER.report()
    assert TRACER.report() == rep

    # the tree: one root, each span under its parent, times read
    names = [s["name"] for s in rep]
    assert [(s["name"], None if s["parent"] is None
             else names[s["parent"]]) for s in rep] == TREES[kind]
    assert all(s["root"] == 0 for s in rep)
    assert all(s["host_ms"] >= 0 and s["device_ms"] == s["host_ms"]
               for s in rep)

    # the counters: one pair count a binning, as the binning gave it
    counted = [(s["counters"]["pairs"], s["counters"]["max_pairs"])
               for s in rep if s["name"] == "render.binning"]
    assert counted == seen and len(seen) == names.count("render.binning")
    # and group_bin_fused on a frame's binning: 1 where the group stream's
    # kernels built it, so 0 on the CPU
    assert all(set(s["counters"]) <= {"pairs", "max_pairs",
                                      "group_bin_fused"} for s in rep)
    assert all(s["counters"].get("group_bin_fused", 0) == 0 for s in rep)

    # the Chrome trace: a user_annotation a span, nested as the spans are
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = sorted(
        (e["ts"], e["ts"] + e["dur"], e["name"])
        for e in json.loads(path.read_text())["traceEvents"]
        if e.get("cat") == "user_annotation" and e["name"] in set(names))
    assert [n for _, _, n in ranges] == names
    for s, (t0, t1, _) in zip(rep, ranges):
        if s["parent"] is not None:
            p0, p1, _ = ranges[s["parent"]]
            assert p0 <= t0 <= t1 <= p1, s

    # tracing changes no bit of the item's outputs
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_spans_on_another_thread_take_the_roots_innermost_span(
        monkeypatch):
    # autograd runs a CUDA backward on a thread of its own, which it hands
    # the profiler's state; a plain thread does not inherit it
    monkeypatch.setattr(profiling, "_profiling", lambda: True)

    def worker():
        with TRACER.span("inner"):
            TRACER.count(pairs=torch.tensor(3), max_pairs=8)

    with TRACER.span("outer", root=True):
        with TRACER.span("middle"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    with TRACER.span("orphan"):
        pass
    rep = TRACER.report()
    assert [(s["name"], s["parent"], s["root"]) for s in rep] == [
        ("outer", None, 0), ("middle", 0, 0), ("inner", 1, 0),
        ("orphan", None, None)]
    assert rep[2]["counters"] == {"pairs": 3, "max_pairs": 8}
    TRACER.reset()
    assert TRACER.report() == []


def test_span_off_is_the_shared_null_context():
    assert TRACER.span("render.frame", root=True) is profiling._OFF
    TRACER.count(pairs=1)
    assert TRACER.report() == []


def _stage_marks(loss) -> tuple[int, int]:
    """(stage marks, all nodes) in the autograd graph behind `loss`."""
    seen, todo = set(), [loss.grad_fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        todo.extend(g for g, _ in f.next_functions)
    marks = sum(type(f).__name__ == "_StageMarkBackward" for f in seen)
    return marks, len(seen)


def test_untraced_step_builds_no_stage_mark(scene, monkeypatch):
    # the loss each step's backward ran from, and the stages it was given
    got = []
    loss_fn = trainer.render_loss_tiled

    def keep(*args, **kw):
        loss = loss_fn(*args, **kw)
        got.append((args[6], loss))
        return loss
    monkeypatch.setattr(trainer, "render_loss_tiled", keep)
    off = _item("train", scene)()
    on_call = _item("train", scene)
    with profile(activities=[ProfilerActivity.CPU]):
        on = on_call()
    (s_off, l_off), (s_on, l_on) = got
    assert s_off is None and s_on is not None
    marks_off, nodes_off = _stage_marks(l_off)
    marks_on, nodes_on = _stage_marks(l_on)
    # untraced: no mark and no hook; traced: the same graph and five marks
    # (loss, image, projection outputs, cloud, leaves)
    assert marks_off == 0 and l_off._backward_hooks is None
    assert marks_on == 5 and nodes_on == nodes_off + 5
    assert s_on.open is None        # the last mark closed its stage
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_backward_stages_run_one_after_another(scene, tmp_path):
    call = _item("train", scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    rep = TRACER.report()
    back = [i for i, s in enumerate(rep) if s["name"] == "train.backward"]
    assert len(back) == 1
    stages = [s for s in rep if s["parent"] == back[0]]
    assert [s["name"] for s in stages] == BACKWARD_STAGES
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"])
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"] in set(BACKWARD_STAGES) | {"train.backward"}}
    b0, b1 = ranges["train.backward"]
    order = [ranges[n] for n in BACKWARD_STAGES]
    assert all(b0 <= t0 <= t1 <= b1 for t0, t1 in order)
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    assert sum(s["host_ms"] for s in stages) <= rep[back[0]]["host_ms"]


def test_begin_and_end_close_a_span_in_a_later_call():
    # no profiler at begin: nothing is opened, and end(None) does nothing
    h = TRACER.begin("stage")
    assert h is None
    with profile(activities=[ProfilerActivity.CPU]):
        TRACER.end(h)
    assert TRACER.report() == []
    # a profiler that stops between the two: the span is still closed
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with TRACER.span("item", root=True):
        h = TRACER.begin("stage")
        prof.stop()
        TRACER.end(h)
        with TRACER.span("after"):
            pass
    rep = TRACER.report()
    assert [(s["name"], s["parent"], s["root"]) for s in rep] == [
        ("item", None, 0), ("stage", 0, 0)]
    assert all(s["host_ms"] is not None for s in rep)


class _Fails(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("backward failed")


def test_a_backward_that_raises_leaves_no_stage_open(monkeypatch):
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    x = torch.ones(3, requires_grad=True)
    opt = torch.optim.SGD([x], lr=0.1)

    def loss_fn(stages):
        y, = stages.mark(None, x)
        loss, = stages.mark("stage.a", (_Fails.apply(y) * 2).sum())
        return loss
    with pytest.raises(RuntimeError, match="backward failed"):
        trainer._step(loss_fn, opt)
    with TRACER.span("next", root=True):
        pass
    rep = TRACER.report()
    names = [s["name"] for s in rep]
    assert [(n, None if s["parent"] is None else names[s["parent"]])
            for n, s in zip(names, rep)] == [
        ("train.step", None), ("train.backward", "train.step"),
        ("stage.a", "train.backward"), ("next", None)]
    assert all(s["host_ms"] is not None for s in rep)
