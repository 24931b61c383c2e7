"""gsrt_torch serving (`serving.py`: update_cutoff_map, ServingRenderer)
and camera paths (`scene/campath.py`) against the JAX package, and the
slice as a whole: the same scene and paths through both serving loops
(CPU; JAX Pallas kernels in interpret mode with blend_math="f32").

Tolerances: camera matrices and intrinsics bit for bit; per frame the
pair totals, violations, re-renders, cull flags and overflow equal, the
cutoff maps equal (the same +inf tiles, finite entries within 1e-6: they
are pair depths read back from the same bf16 payload words); images
within 1e-4 (projection and SH reassociate between XLA and PyTorch, and
the JAX kernel multiplies a chunk's transmittances as a scan where the
port goes pair by pair).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import gaussian_rt as j_rt
from gsrt.scene import campath as j_path
from gsrt.scene.catalog import random_cloud as j_random_cloud
from gsrt.serving import ServingRenderer as JServing

from gsrt_torch import RenderConfig
from gsrt_torch.interop import camera_from_numpy, cloud_from_numpy
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.scene import campath as t_path
from gsrt_torch.serving import ServingRenderer

W, H = 96, 64
MP = 1 << 15
# tests/test_serving.py's configuration: 16x16 tiles on a 6x4 grid with
# 2x2-tile supertiles, the tile stream at 128-pair chunks
KW = dict(width=W, height=H, conic_mode="standard", tile_w=16, tile_h=16,
          blend_impl="packed", serving_super=2, stream="tile",
          pair_chunk=128)
ORBIT = dict(radius=10.0, height=2.0, width=W, height_px=H, degrees=6.0,
             start_deg=200.0)


def port_camera(jcam):
    return camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                             np.asarray(jcam.fy), np.asarray(jcam.cx),
                             np.asarray(jcam.cy), jcam.width, jcam.height,
                             device="cpu")


@pytest.fixture(scope="module")
def scene():
    # big overlapping splats: every tile saturates with headroom to cull
    jc, jcam = j_random_cloud(1500, seed=7, width=W, height=H,
                              scale_range=(0.3, 0.7))
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    return jc, jcam, c, port_camera(jcam)


def run_both(scene, jcams, **srv_kw):
    """Both serving loops over the same cameras: per frame the images and
    the cutoff map after it, then both stats lists."""
    jc, _, c, _ = scene
    jsrv = JServing(JCfg(blend_math="f32", **KW), max_pairs=MP,
                    interpret=True, **srv_kw)
    tsrv = ServingRenderer(RenderConfig(**KW), max_pairs=MP, device="cpu",
                           **srv_kw)
    frames = []
    for jcam in jcams:
        jo = jsrv(jc, jcam)
        to = tsrv(c, port_camera(jcam))
        frames.append((jo, to, np.asarray(jsrv.cutoff_map),
                       tsrv.cutoff_map.numpy()))
    jsrv.finish()
    tsrv.finish()
    return frames, jsrv.stats, tsrv.stats


def assert_frames_match(frames, jstats, tstats):
    keys = ("pairs", "violations", "full_renders", "cull", "overflow",
            "max_pairs")
    assert [{k: s[k] for k in keys} for s in tstats] == \
        [{k: s[k] for k in keys} for s in jstats]
    for i, (jo, to, jmap, tmap) in enumerate(frames):
        np.testing.assert_allclose(to.color.numpy(), np.asarray(jo.color),
                                   atol=1e-4, err_msg=f"frame {i} color")
        np.testing.assert_allclose(to.trans.numpy(), np.asarray(jo.trans),
                                   atol=1e-4, err_msg=f"frame {i} trans")
        np.testing.assert_array_equal(np.isinf(tmap), np.isinf(jmap))
        fin = np.isfinite(jmap)
        np.testing.assert_allclose(tmap[fin], jmap[fin], rtol=0, atol=1e-6,
                                   err_msg=f"frame {i} cutoff map")


def test_camera_paths_match_jax():
    kw = dict(width=64, height_px=48)
    for jp, tp in (
            (j_path.orbit_path((0, 0, 6), 10.0, 5, height=2.0, degrees=60,
                               start_deg=200, **kw),
             t_path.orbit_path((0, 0, 6), 10.0, 5, height=2.0, degrees=60,
                               start_deg=200, device="cpu", **kw)),
            (j_path.orbit_path((0, 0, 0), 5.0, 8, **kw),
             t_path.orbit_path((0, 0, 0), 5.0, 8, device="cpu", **kw)),
            (j_path.dolly_path((0, 0, -5), (0, 0, -2), (0, 0, 0), 5, **kw),
             t_path.dolly_path((0, 0, -5), (0, 0, -2), (0, 0, 0), 5,
                               device="cpu", **kw))):
        assert len(jp) == len(tp)
        for j, t in zip(jp, tp):
            np.testing.assert_array_equal(t.view.numpy(), np.asarray(j.view))
            assert float(t.fy) == float(j.fy) and t.width == j.width
    keys_j = j_path.orbit_path((0, 0, 0), 5.0, 3, degrees=90, **kw)
    keys_t = [port_camera(k) for k in keys_j]
    jp = j_path.interpolate_path(keys_j, 4)
    tp = t_path.interpolate_path(keys_t, 4)
    assert len(tp) == len(jp) == 9 and tp[0].device.type == "cpu"
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.view.numpy(), np.asarray(j.view),
                                   atol=1e-6)


@pytest.mark.parametrize("pipeline_depth", [1, 2])
def test_serving_orbit_matches_jax(scene, pipeline_depth):
    cams = j_path.orbit_path((0, 0, 6.0), n_frames=4, **ORBIT)
    frames, js, ts = run_both(scene, cams, pipeline_depth=pipeline_depth)
    assert_frames_match(frames, js, ts)
    assert any(s["cull"] for s in ts)              # the cull engaged


def test_serving_static_camera_matches_jax_and_converges(scene):
    jc, jcam, c, cam = scene
    frames, js, ts = run_both(scene, [jcam] * 3, pipeline_depth=1)
    assert_frames_match(frames, js, ts)
    assert all(s["violations"] == 0 for s in ts)
    assert ts[2]["pairs"] < ts[0]["pairs"], ts    # later frames cull
    exact = t_rt.render_tiled(c, cam, RenderConfig(**KW), max_pairs=MP)
    for _, to, _, _ in frames:
        np.testing.assert_allclose(to.color.numpy(), exact.color.numpy(),
                                   atol=3e-3)
        np.testing.assert_allclose(to.trans.numpy(), exact.trans.numpy(),
                                   atol=3e-3)


def test_strict_serving_rerenders_like_jax(scene):
    jc, jcam, c, cam = scene
    jsrv = JServing(JCfg(blend_math="f32", **KW), max_pairs=MP, strict=True,
                    interpret=True)
    tsrv = ServingRenderer(RenderConfig(**KW), max_pairs=MP, strict=True,
                           device="cpu")
    jsrv(jc, jcam)
    tsrv(c, cam)
    # an over-tight map: culls nearly everything, so the frame degrades
    jsrv.cutoff_map = jnp.full_like(jsrv.cutoff_map, 1e-3)
    tsrv.cutoff_map = torch.full_like(tsrv.cutoff_map, 1e-3)
    jsrv._use_cull = tsrv._use_cull = True
    jo, to = jsrv(jc, jcam), tsrv(c, cam)
    frames = [(jo, to, np.asarray(jsrv.cutoff_map),
               tsrv.cutoff_map.numpy())]
    jsrv.finish()
    tsrv.finish()
    assert_frames_match(frames, jsrv.stats[1:], tsrv.stats[1:])
    assert tsrv.stats[1]["violations"] > 0
    assert tsrv.stats[1]["full_renders"] == 1
    exact = t_rt.render_tiled(c, cam, RenderConfig(**KW), max_pairs=MP)
    np.testing.assert_allclose(to.trans.numpy(), exact.trans.numpy(),
                               atol=3e-3)


def test_render_tiled_serving_aux_and_empty_cloud(scene):
    jc, jcam, c, cam = scene
    cfg = RenderConfig(**KW)
    out, aux = t_rt.render_tiled(c, cam, cfg, max_pairs=MP, serving=True)
    plain = t_rt.render_tiled(c, cam, cfg, max_pairs=MP)
    # serving is passive on the image
    np.testing.assert_array_equal(out.color.numpy(), plain.color.numpy())
    assert aux.consumed.shape == (1, cfg.blend_bs)
    assert aux.pair_depth.shape == (MP,)
    ts = aux.tile_start.numpy()
    pd = aux.pair_depth.numpy()
    for t in range(len(ts) - 1):          # front to back within each tile
        assert (np.diff(pd[ts[t]:ts[t + 1]]) >= 0).all()
    empty = c._replace(**{k: getattr(c, k)[:0] for k in c._fields})
    eo, ea = t_rt.render_tiled(empty, cam, cfg, max_pairs=MP, serving=True)
    assert float(eo.trans.min()) == 1.0 and ea.consumed.shape == (1, 128)
    with pytest.raises(ValueError, match="serving"):
        t_rt.render_tiled(c, cam, cfg.replace(blend_impl="subtile"),
                          serving=True)


def test_tracer_defers_the_overflow_check(scene):
    _, _, c, cam = scene
    cfg = RenderConfig(**KW)
    exact = t_rt.render_tiled(c, cam, cfg, max_pairs=MP)
    tr = t_rt.GaussianRayTracer(cfg, "tiled", max_pairs=1 << 12,
                                device="cpu", defer_overflow=1)
    first = tr(c, cam)                 # overflows, served truncated
    assert bool(first.overflow) and tr.max_pairs == 1 << 12
    second = tr(c, cam)                # reads frame 1's flag: re-renders
    assert not bool(second.overflow) and tr.max_pairs > 1 << 12
    np.testing.assert_allclose(second.color.numpy(), exact.color.numpy(),
                               atol=1e-6)


def test_serving_entry_points_default_to_cuda():
    cfg = RenderConfig(**KW)
    if torch.cuda.is_available():
        assert ServingRenderer(cfg).device.type == "cuda"
        assert t_path.orbit_path((0, 0, 0), 5.0, 2)[0].view.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingRenderer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_path.orbit_path((0, 0, 0), 5.0, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_path.dolly_path((0, 0, -5), (0, 0, -2), (0, 0, 0), 2)
