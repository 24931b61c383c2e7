"""gsrt_torch `render_tiled`, its binning and `GaussianRayTracer`, held
against the JAX package on the same NumPy scene (CPU; JAX Pallas kernels
in interpret mode).

Tolerances:
  * binning: tile_start, tile_count, total_pairs and overflow exact; the
    per-tile decoded pair lists equal in order (tile ids and rgba8 exact,
    mean codes within one u16 step, bf16 halves within one bf16 ulp). Raw
    column order across tiles is not contractual and is not compared;
  * render_tiled at defaults: atol 2e-2 against JAX render_tiled at
    defaults (its bf16 blend tier), 2e-3 against JAX with blend_math="f32"
    (tests/test_group_stream.py:52-55), and 2e-2 against the port's own
    render_fast (tests/test_group_stream.py:68-69).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import gaussian_rt as j_rt
from gsrt.ops.gaussian import screen_extents_abc as j_extents
from gsrt.ops.tile_binning import build_tile_binning as j_build
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import RenderConfig
from gsrt_torch.interop import camera_from_numpy, cloud_from_numpy
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import tile_binning as t_tb

W = H = 256
MP, MR = 1 << 16, 1 << 14


def _port(jc, jcam):
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), jcam.width, jcam.height,
                            device="cpu")
    return c, cam


@pytest.fixture(scope="module")
def scene():
    jc, jcam = j_random_cloud(3000, seed=0, width=W, height=H)
    return (jc, jcam) + _port(jc, jcam)


@pytest.fixture(scope="module")
def port_out(scene):
    _, _, c, cam = scene
    out = t_rt.render_tiled(c, cam, RenderConfig(width=W, height=H),
                            max_pairs=MP, max_rows=MR)
    assert not bool(out.overflow)
    return out


def _canonical(payload, tile_start, T, bs):
    """Per-tile pair lists, each in payload order, tiles ascending (rows
    past the payload's fifth ride along)."""
    pay = np.asarray(payload)
    ts = np.asarray(tile_start)
    parts = []
    for g0 in range(0, T, bs):
        seg = pay[:, ts[g0]:ts[min(g0 + bs, T)]]
        parts.append(seg[:, np.argsort(seg[4], kind="stable")])
    return np.concatenate(parts, axis=1)


def test_binning_matches_jax(scene):
    jc, jcam, c, cam = scene
    jcfg = JCfg(width=W, height=H)
    depth, m2x, m2y, qa, qb, qc, inf, cr, cg, cb = j_rt._precompute_fm(
        j_rt.fm_from_cloud(jc), jcam, jcfg)
    rx, ry = j_extents(qa, qb, qc, "standard", 5.6, opacity=jc.opacity)
    alive = inf & (jc.opacity > 1 / 255) & (depth > 1e-3) & (depth < 1e4)
    cols = [depth, m2x, m2y, qa, qb, qc, jc.opacity, cr, cg, cb, rx, ry,
            alive]
    jb = j_build(*cols, width=W, height=H, tile_w=32, tile_h=16, chunk=384,
                 max_pairs=MP, expand_impl="fused", interpret=True,
                 compact=True, max_rows=MR, stream="group", carry_depth=True)
    tb = t_tb.build_tile_binning(
        *(torch.as_tensor(np.array(a)) for a in cols), width=W, height=H,
        max_pairs=MP, max_rows=MR, carry_depth=True)
    for name in ("tile_start", "tile_count", "total_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    total = int(tb.total_pairs)
    assert total > 5000 and tb.payload.shape == (5, MP)
    T, bs = 8 * 16, 8 * 16
    j = _canonical(np.asarray(jb.payload)[:5, :MP], jb.tile_start, T, bs)
    t = _canonical(tb.payload.numpy(), tb.tile_start.numpy(), T, bs)
    assert j.shape == t.shape == (5, total)
    np.testing.assert_array_equal(t[4], j[4])      # tile ids, in order
    np.testing.assert_array_equal(t[3], j[3])      # rgba8
    for row in (0, 1, 2):                          # mean codes, bf16 halves
        for shift in (16, 0):
            a = (t[row] >> shift) & 0xFFFF
            b = (j[row] >> shift) & 0xFFFF
            assert np.abs(a - b).max() <= 1, (row, shift)
    assert (tb.payload[4, total:] == T).all()
    # the depth half of qcd, column by column, as the JAX package carries it
    jd = np.asarray(jb.pair_depth)
    np.testing.assert_array_equal(
        _canonical(np.concatenate([tb.payload.numpy(),
                                   tb.pair_depth.numpy()[None].view(
                                       np.int32)]), tb.tile_start.numpy(),
                   T, bs)[5],
        _canonical(np.concatenate([np.asarray(jb.payload)[:5, :MP],
                                   jd[None, :MP].view(np.int32)]),
                   jb.tile_start, T, bs)[5])


def test_render_tiled_matches_jax_defaults(scene, port_out):
    jc, jcam, _, _ = scene
    j = j_rt.render_tiled(jc, jcam, JCfg(width=W, height=H), max_pairs=MP,
                          max_rows=MR, interpret=True)
    np.testing.assert_allclose(port_out.color.numpy(), np.asarray(j.color),
                               atol=2e-2)
    np.testing.assert_allclose(port_out.trans.numpy(), np.asarray(j.trans),
                               atol=2e-2)
    np.testing.assert_array_equal(port_out.hits.numpy(), np.asarray(j.hits))


def test_render_tiled_matches_jax_f32_blend(scene, port_out):
    jc, jcam, _, _ = scene
    j = j_rt.render_tiled(jc, jcam, JCfg(width=W, height=H,
                                         blend_math="f32"),
                          max_pairs=MP, max_rows=MR, interpret=True)
    np.testing.assert_allclose(port_out.color.numpy(), np.asarray(j.color),
                               atol=2e-3)
    np.testing.assert_allclose(port_out.trans.numpy(), np.asarray(j.trans),
                               atol=2e-3)


def test_render_tiled_matches_render_fast(scene, port_out):
    _, _, c, cam = scene
    ref = t_rt.render_fast(c, cam, RenderConfig(width=W, height=H))
    assert torch.isfinite(port_out.color).all()
    np.testing.assert_allclose(port_out.color.numpy(), ref.color.numpy(),
                               atol=2e-2)


def test_tracer_calibrates_and_rerenders_on_overflow(scene, port_out):
    jc, jcam, c, cam = scene
    cfg = RenderConfig(width=W, height=H)
    tr = t_rt.GaussianRayTracer(cfg, "tiled", max_pairs=1 << 12,
                                device="cpu")
    out = tr(c, cam)                     # overflows, re-sizes, re-renders
    assert not bool(out.overflow)
    assert tr.max_rows is not None
    jt = j_rt.GaussianRayTracer(JCfg(width=W, height=H), "tiled")
    assert tr.max_pairs == jt.calibrate(jc, jcam)
    assert tr.max_rows == jt.max_rows
    np.testing.assert_allclose(out.color.numpy(), port_out.color.numpy(),
                               atol=1e-6)


def test_unit_overflow_flag(scene):
    _, _, c, cam = scene
    out = t_rt.render_tiled(c, cam, RenderConfig(width=W, height=H),
                            max_pairs=MP, max_rows=256)
    assert bool(out.overflow)


def test_calibrate_gates_on_post_fallback_span_mode():
    # ellipse spans need nty <= 255: at nty = 258 render_tiled falls back
    # to rect spans and so takes the group stream; calibrate must size the
    # unit buffer for it (the JAX package's calibrate leaves it unsized)
    cfg = RenderConfig(width=64, height=4128, span_mode="ellipse")
    jc, jcam = j_random_cloud(400, seed=2, width=64, height=4128)
    c, cam = _port(jc, jcam)
    plan = t_rt.stream_plan(cfg, 64, 4128)
    assert (plan.span_mode, plan.stream) == ("rect", "group")
    tr = t_rt.GaussianRayTracer(cfg, "tiled", device="cpu")
    tr.calibrate(c, cam)
    _, units = t_rt.count_units_numpy(c, cam, cfg, plan.group_k)
    assert tr.max_rows == t_rt.pair_bucket(int(units * 1.1))
    jt = j_rt.GaussianRayTracer(JCfg(width=64, height=4128,
                                     span_mode="ellipse"), "tiled")
    jt.calibrate(jc, jcam)
    assert jt.max_rows is None           # the reference defect
    out = tr(c, cam)
    assert not bool(out.overflow)
    ref = t_rt.render_fast(c, cam, cfg)
    np.testing.assert_allclose(out.color.numpy(), ref.color.numpy(),
                               atol=2e-2)


@pytest.mark.parametrize("kw", [dict(stream="tile"), dict(payload="f32"),
                                dict(span_mode="ellipse"),
                                dict(scan_impl="roll"),
                                dict(tile_w=128, tile_h=8)])
def test_tile_streams_match_jax(scene, kw):
    """Each configuration the JAX package renders on another stream than
    the group stream (the compact or f32 tile stream through the packed
    tile kernel, ellipse spans on the compact tile stream, the (128, 8)
    tiles through blend_tiles) matches the JAX package with its f32
    blend, atol 1e-4."""
    jc, jcam, c, cam = scene
    plan = t_rt.stream_plan(RenderConfig(width=W, height=H, **kw), W, H)
    assert plan.stream == "tile"
    j = j_rt.render_tiled(jc, jcam, JCfg(width=W, height=H, blend_math="f32",
                                         **kw), max_pairs=MP, interpret=True)
    t = t_rt.render_tiled(c, cam, RenderConfig(width=W, height=H, **kw),
                          max_pairs=MP)
    assert not bool(t.overflow)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color),
                               atol=1e-4)
    np.testing.assert_allclose(t.trans.numpy(), np.asarray(j.trans),
                               atol=1e-4)
    np.testing.assert_array_equal(t.hits.numpy(), np.asarray(j.hits))


@pytest.mark.parametrize("stream", ["tile", "group"])
def test_exact_hits_and_lut_match_jax(scene, stream):
    """exact_hits and the LUT together. On the tile stream the port gates
    chunks as the JAX kernel does, so hits agree except where the compact
    payload's two forms of the response round across alpha_threshold
    (at most 0.1% of pixels, by one). The port's group kernel stops per
    tile and per batch of tile_w·tile_h columns where the JAX kernel
    gates 384-pair chunks of interleaved tiles, so hits agree exactly in
    the tiles that never saturate and may be fewer in the others."""
    jc, jcam, c, cam = scene
    kw = dict(width=W, height=H, stream=stream, exact_hits=True,
              use_exp_lut=True)
    j = j_rt.render_tiled(jc, jcam, JCfg(blend_math="f32", **kw),
                          max_pairs=MP, max_rows=MR, interpret=True)
    t = t_rt.render_tiled(c, cam, RenderConfig(**kw), max_pairs=MP,
                          max_rows=MR)
    jh, th = np.asarray(j.hits), t.hits.numpy()
    assert jh.max() > 10
    atol = 1e-4 if stream == "tile" else 2e-3
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color),
                               atol=atol)
    np.testing.assert_allclose(t.trans.numpy(), np.asarray(j.trans),
                               atol=atol)
    if stream == "tile":
        diff = th - jh
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-3
        return
    tiles = lambda a: a.reshape(H // 16, 16, W // 32, 32).swapaxes(1, 2)
    never_sat = (tiles(t.trans.numpy()).min((2, 3)) >= 1e-4)
    assert never_sat.any() and (~never_sat).any()
    np.testing.assert_array_equal(tiles(th)[never_sat], tiles(jh)[never_sat])
    assert (th <= jh).all()


def test_reference_demo_renders_tiled():
    """The reference's own configuration (REFERENCE_DEMO: LUT exp,
    conic_mode "reference") renders tiled, against the JAX package and
    against the port's render_fast."""
    from gsrt.core.config import REFERENCE_DEMO as J_DEMO
    from gsrt.scene.catalog import demo_gauss_splat as j_demo

    from gsrt_torch import REFERENCE_DEMO
    jc, jcam = j_demo(16, 16)
    c, cam = _port(jc, jcam)
    j = j_rt.render_tiled(jc, jcam, J_DEMO.replace(blend_math="f32"),
                          max_pairs=1 << 14, interpret=True)
    t = t_rt.render_tiled(c, cam, REFERENCE_DEMO, max_pairs=1 << 14)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color),
                               atol=1e-5)
    fast = t_rt.render_fast(c, cam, REFERENCE_DEMO)
    np.testing.assert_allclose(t.color.numpy(), fast.color.numpy(),
                               atol=2e-2)
    assert float(t.trans.min()) < 0.5


def test_reference_mode_not_ported():
    """"reference" mode is ported now: GaussianRayTracer dispatches to
    render_reference (held against the JAX package in
    tests/test_torch_kbuffer.py), and an unknown mode raises."""
    from gsrt_torch import REFERENCE_DEMO
    from gsrt.scene.catalog import demo_gauss_splat as j_demo
    c, cam = _port(*j_demo(16, 16))
    out = t_rt.GaussianRayTracer(REFERENCE_DEMO, "reference",
                                 device="cpu")(c, cam)
    want = t_rt.render_reference(c, cam, REFERENCE_DEMO)
    assert torch.equal(out.trans, want.trans) and out.passes.max() >= 1
    with pytest.raises(ValueError):
        t_rt.GaussianRayTracer(RenderConfig(), "bogus", device="cpu")
