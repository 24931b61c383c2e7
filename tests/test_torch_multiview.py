"""gsrt_torch COLMAP loading (`scene/colmap.py`) and multi-view fitting
(`models/multiview.py`) against the JAX package's on the same NumPy inputs
(CPU; the JAX package's Pallas kernels in interpret mode).

Tolerances:
  * COLMAP readers, writers and pose conversions: equal (the same NumPy
    arithmetic); init_params_from_points: rtol 1e-6;
  * one tiled multi-view step: loss rtol 1e-5 (as render_loss_tiled's
    test), the accumulated gradient norms within 1e-3 of their largest
    (two backward kernels that sum in another order), counts equal;
  * fit_views at 64×48 on 3 views, one densify event and one opacity
    reset, on the render_fast loss and on the tiled loss against the JAX
    package's render_fast fit: the same views in the same order and the
    same N after the event, exactly; losses at rtol 1e-3, the tolerance
    of the tiled train step's test; PSNRs within 0.05 dB.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.core.types import look_at, make_camera as j_camera
from gsrt.models import densify as j_dn
from gsrt.models import multiview as j_mv
from gsrt.models import trainer as j_tr
from gsrt.models.gaussian_rt import render_fast as j_render_fast
from gsrt.scene import colmap as j_cm

from gsrt_torch import RenderConfig
from gsrt_torch.interop import (camera_from_numpy, params_from_numpy,
                                params_to_numpy, stats_to_numpy)
from gsrt_torch.models import densify as t_dn
from gsrt_torch.models import multiview as t_mv
from gsrt_torch.models import trainer as t_tr
from gsrt_torch.scene import colmap as t_cm

W, H, MP = 64, 48, 1 << 13
TILED = dict(width=W, height=H, conic_mode="standard", tile_w=16,
             tile_h=16, pair_chunk=128)


def _model(n_views=3, n_pts=40, seed=0):
    """A posed capture of n_views around the origin and n_pts SfM points
    (the JAX package's model types, which the port's readers share)."""
    rng = np.random.default_rng(seed)
    cams = {1: j_cm.ColmapCamera("PINHOLE", W, H, 50.0, 52.0, 32.0, 24.0)}
    images = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = (3 * np.sin(ang), 0.5, 3 * np.cos(ang))
        images.append(j_cm.ColmapImage(
            name=f"im_{(7 * i) % n_views:03d}.png", camera_id=1,
            view=look_at(eye, (0, 0, 0)).astype(np.float32)))
    pts = rng.normal(0, 0.6, (n_pts, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    return j_cm.ColmapModel(cameras=cams, images=images, points=pts,
                            colors=cols)


def _assert_models_equal(got, want):
    assert got.cameras == want.cameras
    assert [im.name for im in got.images] == [im.name for im in want.images]
    assert [im.camera_id for im in got.images] == \
        [im.camera_id for im in want.images]
    for a, b in zip(got.images, want.images):
        np.testing.assert_array_equal(a.view, b.view)
        assert a.view.dtype == b.view.dtype
    for a, b in ((got.points, want.points), (got.colors, want.colors)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_colmap_round_trip_matches_jax(tmp_path, fmt):
    """A model written by the JAX package's writer reads the same through
    both readers; the port's writer writes the same bytes."""
    model = _model()
    writer = {"text": "write_text_model", "binary": "write_binary_model"}
    getattr(j_cm, writer[fmt])(str(tmp_path / "jax"), model)
    getattr(t_cm, writer[fmt])(str(tmp_path / "port"), model)
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
    got = t_cm.load_colmap_model(str(tmp_path / "jax"))
    _assert_models_equal(got, j_cm.load_colmap_model(str(tmp_path / "jax")))
    assert [im.name for im in got.images] == \
        sorted(im.name for im in model.images)
    # a scene root holding sparse/0 is found too
    os.makedirs(tmp_path / "scene" / "sparse")
    os.rename(tmp_path / "jax", tmp_path / "scene" / "sparse" / "0")
    _assert_models_equal(t_cm.load_colmap_model(str(tmp_path / "scene")),
                         got)
    with pytest.raises(FileNotFoundError):
        t_cm.load_colmap_model(str(tmp_path / "nothing"))


def test_poses_extent_knn_and_init_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(10):
        q = rng.normal(size=4)
        R = t_cm.quat_to_rot(*q)
        np.testing.assert_array_equal(R, j_cm.quat_to_rot(*q))
        np.testing.assert_array_equal(t_cm.rot_to_quat(R),
                                      j_cm.rot_to_quat(R))
        t = rng.normal(size=3)
        np.testing.assert_array_equal(t_cm._view_from_qt(q, t),
                                      j_cm._view_from_qt(q, t))
    model = _model(n_views=5, n_pts=300)
    assert t_cm.scene_extent(model) == j_cm.scene_extent(model)
    np.testing.assert_array_equal(t_cm.knn_mean_dist(model.points),
                                  j_cm.knn_mean_dist(model.points))
    for deg in (0, 2):
        got = t_cm.init_params_from_points(model.points, model.colors,
                                           sh_degree=deg, device="cpu")
        want = j_cm.init_params_from_points(model.points, model.colors,
                                            sh_degree=deg)
        for g, w in zip(params_to_numpy(got), want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)


def test_viewset_from_colmap_and_holdout_match_jax(tmp_path):
    from PIL import Image
    model = _model(n_views=4)
    j_cm.write_binary_model(str(tmp_path / "sparse" / "0"), model)
    rng = np.random.default_rng(5)
    for im in model.images:
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                        ).save(tmp_path / im.name)
    for kw in (dict(), dict(downscale=2, limit=3)):
        vs, params, ext = t_mv.viewset_from_colmap(
            str(tmp_path), str(tmp_path), device="cpu", **kw)
        jvs, jparams, jext = j_mv.viewset_from_colmap(
            str(tmp_path), str(tmp_path), **kw)
        assert ext == jext and vs.n_views == jvs.n_views
        assert (vs.width, vs.height) == (jvs.width, jvs.height)
        for g, w in zip(vs, jvs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(params_to_numpy(params), jparams):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)
        sub = vs.select([2, 0])
        np.testing.assert_array_equal(sub.images[1].numpy(),
                                      vs.images[0].numpy())
    for n, h in [(10, 8), (28, 7), (3, 0), (1, 8), (3, 8)]:
        assert t_mv.holdout_split(n, h) == j_mv.holdout_split(n, h)


def _capture(n_views: int = 3):
    """Targets rendered by the JAX package from a ground-truth cloud, and
    the start: init_params_from_points of the model's SfM points, as both
    packages' NumPy arrays."""
    rng = np.random.default_rng(1)
    model = _model(n_views=n_views, n_pts=60)
    gt = j_tr.GaussianParams(
        means=jnp.asarray(rng.normal(0, 0.6, (120, 3)), jnp.float32),
        log_scales=jnp.full((120, 3), np.log(0.12), jnp.float32),
        quats=jnp.tile(jnp.array([1.0, 0, 0, 0]), (120, 1)),
        opacity_logit=jnp.full((120,), 1.0, jnp.float32),
        sh=jnp.asarray(rng.normal(0, 1, (120, 1, 3)), jnp.float32))
    cam = model.cameras[1]
    jcams = [j_camera(im.view, 50.0, W, H) for im in model.images]
    jcams = [c.__class__(view=c.view, fx=jnp.float32(cam.fx),
                         fy=jnp.float32(cam.fy), cx=jnp.float32(cam.cx),
                         cy=jnp.float32(cam.cy), width=W, height=H)
             for c in jcams]
    targets = [np.array(j_render_fast(gt.to_cloud(), c, JCfg(
        width=W, height=H, conic_mode="standard")).color) for c in jcams]
    start = [np.asarray(a) for a in j_cm.init_params_from_points(
        model.points, model.colors)]
    tcams = [camera_from_numpy(np.asarray(c.view), cam.fx, cam.fy, cam.cx,
                               cam.cy, W, H, device="cpu") for c in jcams]
    return (j_mv.viewset_from_cameras(jcams, targets),
            t_mv.viewset_from_cameras(tcams, targets, device="cpu"), start)


def test_tiled_mv_step_matches_jax():
    jvs, tvs, start = _capture()
    jopt = j_tr.make_optimizer()
    jp = j_tr.GaussianParams(*(jnp.asarray(a) for a in start))
    jstep = j_mv.make_train_step_mv(JCfg(**TILED), jopt, max_pairs=MP,
                                    interpret=True)
    n = start[0].shape[0]
    _, _, jstats, jloss = jstep(jp, jopt.init(jp), j_dn.init_stats(n), jvs,
                                jnp.int32(1))
    tp = params_from_numpy(*start, device="cpu")
    step = t_mv.make_train_step_mv(RenderConfig(**TILED), max_pairs=MP)
    tstats, tloss = step(tp, t_tr.make_optimizer(tp),
                         t_dn.init_stats(n, "cpu"), tvs, 1)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = stats_to_numpy(tstats)
    want = np.asarray(jstats.grad_accum)
    assert want.max() > 0 and got[1].sum() > 0
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-3 * want.max())
    np.testing.assert_array_equal(got[1], np.asarray(jstats.count))


def test_tiled_mv_step_grows_its_pair_buffer():
    """A view that needs more pairs than max_pairs grows the buffer and
    takes its step: the same loss, parameters and statistics, bit for bit,
    as a step whose buffer was large enough from the start; the step
    records the growth."""
    from gsrt_torch.models.gaussian_rt import count_pairs, pair_bucket
    _, tvs, start = _capture()
    n = start[0].shape[0]
    with torch.no_grad():
        need = count_pairs(params_from_numpy(*start, device="cpu").to_cloud(),
                           tvs.camera_at(1), RenderConfig(**TILED))
    assert 64 < int(need) <= MP
    outs = []
    for mp in (64, MP):
        tp = params_from_numpy(*start, device="cpu")
        growths = []
        step = t_mv.make_train_step_mv(RenderConfig(**TILED), max_pairs=mp,
                                       growths=growths)
        stats, loss = step(tp, t_tr.make_optimizer(tp),
                           t_dn.init_stats(n, "cpu"), tvs, 1)
        outs.append((loss, params_to_numpy(tp), stats_to_numpy(stats)))
        assert growths == ([(int(need), pair_bucket(int(need * 1.1)))]
                           if mp == 64 else [])
    (l0, p0, s0), (l1, p1, s1) = outs
    assert torch.equal(l0, l1)
    for a, b in zip(p0 + s0, p1 + s1):
        np.testing.assert_array_equal(a, b)


FIT = dict(iters=12, holdout=3, densify_every=6, densify_grad=1e-3,
           scene_scale=30.0, opacity_reset_every=8, max_splats=75, bucket=16,
           seed=4)


@pytest.fixture(scope="module")
def jax_fit():
    """The capture and the JAX package's fit_views of it on its render_fast
    loss, the reference of both cases of test_fit_views_matches_jax:
    (port viewset, start, JAX params, JAX report)."""
    jvs, tvs, start = _capture()
    jp, jrep = j_mv.fit_views(
        jvs, j_tr.GaussianParams(*(jnp.asarray(a) for a in start)),
        JCfg(**TILED), **FIT)
    return tvs, start, jp, jrep


@pytest.mark.parametrize("path", ["fast", "tiled"])
def test_fit_views_matches_jax(monkeypatch, jax_fit, path):
    """A fit with one densify event (after step 6: clones and splits, the
    budget binding) and one opacity reset (after step 8), on the port's
    render_fast loss and on its tiled loss, against the JAX package's
    fit_views on its render_fast loss. (The JAX package's tiled fit stops
    on the CPU at the second step after a densify event: XLA reports
    "Execution supplied 29 buffers but compiled program expected 30".)"""
    tvs, start, jp, jrep = jax_fit
    seen, events = [], []
    make_step, densify = t_mv.make_train_step_mv, t_mv.densify_and_prune

    def recording_step(*a, **k):
        step = make_step(*a, **k)

        def run(params, optimizer, stats, vs, i):
            seen.append(i)
            return step(params, optimizer, stats, vs, i)
        return run

    def recording_densify(*a, **k):
        out = densify(*a, **k)
        events.append(out[3])
        return out
    monkeypatch.setattr(t_mv, "make_train_step_mv", recording_step)
    monkeypatch.setattr(t_mv, "densify_and_prune", recording_densify)
    tp, trep = t_mv.fit_views(
        tvs, params_from_numpy(*start, device="cpu"), RenderConfig(**TILED),
        max_pairs=MP if path == "tiled" else None, **FIT)
    # the JAX package's epoch-shuffled order over the train split
    rng, order, want = np.random.default_rng(4), [], []
    for _ in range(12):
        order = order or list(rng.permutation([1, 2]))
        want.append(int(order.pop()))
    assert seen == want
    (rep,) = events
    assert rep.n_cloned > 0 and rep.n_split > 0 and rep.n_after == 75
    assert trep.n_splats == jrep.n_splats == jp.means.shape[0] == \
        t_dn.round_up_to(rep.n_after, 16)
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-3)
    assert np.isfinite([trep.train_psnr, trep.test_psnr]).all()
    np.testing.assert_allclose([trep.train_psnr, trep.test_psnr],
                               [jrep.train_psnr, jrep.test_psnr], atol=0.05)
    # the reset capped every opacity at 0.01 four steps before the end
    assert params_to_numpy(tp)[3].max() < np.log(0.01 / 0.99) + 0.5


def test_multiview_entry_points_default_to_cuda():
    model = _model()
    cam = camera_from_numpy(np.eye(4), 50.0, 50.0, 32.0, 24.0, W, H,
                            device="cpu")
    img = np.zeros((H, W, 3), np.float32)
    if torch.cuda.is_available():
        assert t_mv.viewset_from_cameras([cam], [img]).images.is_cuda
        assert t_cm.init_params_from_points(model.points,
                                            model.colors).means.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mv.viewset_from_cameras([cam], [img])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_cm.init_params_from_points(model.points, model.colors)
