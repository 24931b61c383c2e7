"""gsrt_torch f32 tile stream (`ops/tile_binning.py`, compact=False) and
subtile blend (`ops/splat_subtile.py`) against the JAX package on the same
NumPy columns (CPU; JAX Pallas kernels in interpret mode).

Tolerances:
  * binning with ids: payload rows 0-7 over all max_pairs columns,
    tile_start, tile_count, total_pairs, overflow, sorted_base and
    sorted_touched bit for bit; sorted_orig bit for bit over the splats
    that emit pairs (the depth sort is unstable in both packages, so the
    order of the splats behind them, which all carry the key +inf, is not
    contractual: there the two must hold the same set). The port's payload
    has no chunk + 128 column tail (a TPU DMA artefact);
  * blend_subtiles: atol 1e-5 on color and trans — the same f32
    arithmetic, summed per pixel in pair order where the JAX kernel sums a
    chunk's lanes as a tree;
  * render_tiled with blend_impl="subtile": atol 1e-4 (projection and SH
    reassociate between XLA and PyTorch on top of the blend).
The CUDA kernels are held against the plain versions in
tests/test_torch_gpu.py, which needs a card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import gaussian_rt as j_rt
from gsrt.ops import splat_subtile as j_sub
from gsrt.ops import tile_binning as j_tb
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import RenderConfig
from gsrt_torch.interop import camera_from_numpy, cloud_from_numpy
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import splat_subtile as t_sub
from gsrt_torch.ops import tile_binning as t_tb

W, H, MP = 64, 48, 1 << 13
BLEND = dict(g_cutoff=5.6, alpha_threshold=1.0 / 255.0, alpha_clamp=0.99)


def make_columns(seed: int, n: int = 400, wall_rank: int | None = None):
    """The 13 per-splat columns build_tile_binning takes, drawn with NumPy:
    distinct depths, means over (and a little past) the image, positive
    definite conics of 2-8 px splats, colours partly above 1, a tenth of
    the splats culled. With `wall_rank`, the three splats at that depth
    rank and the next two cover the whole image at an opacity the blend
    clamps: they leave 1e-6 < term_eps behind, so every tile stops at its
    next chunk boundary."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    depth = f32(rng.permutation(n) * 0.01 + 1.0)
    m2x, m2y = f32(rng.uniform(-4, W + 4, n)), f32(rng.uniform(-4, H + 4, n))
    sx, sy = rng.uniform(2, 8, n), rng.uniform(2, 8, n)
    rho = rng.uniform(-0.6, 0.6, n)
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    qa, qb, qc = f32(sy ** 2 / det), f32(-rho * sx * sy / det), \
        f32(sx ** 2 / det)
    opacity = f32(rng.uniform(0.2, 0.95, n))
    cr, cg, cb = (f32(rng.uniform(0.0, 1.3, n)) for _ in range(3))
    rx, ry = f32(3.2 * sx), f32(3.2 * sy)
    alive = rng.uniform(size=n) > 0.1
    if wall_rank is not None:
        wall = np.argsort(depth)[wall_rank:wall_rank + 3]
        qa[wall], qb[wall], qc[wall] = 1e-6, 0.0, 1e-6
        opacity[wall], alive[wall] = 0.999, True
        rx[wall] = ry[wall] = 1e4
    return [depth, m2x, m2y, qa, qb, qc, opacity, cr, cg, cb, rx, ry, alive]


def jax_binning(cols, tile, expand_impl="fused", with_ids=True):
    return j_tb.build_tile_binning(
        *(jnp.asarray(c) for c in cols), width=W, height=H, tile_w=tile[0],
        tile_h=tile[1], chunk=128, max_pairs=MP, expand_impl=expand_impl,
        interpret=True, with_ids=with_ids)


def port_binning(cols, tile, expand_impl="fused", with_ids=True):
    return t_tb.build_tile_binning(
        *(torch.as_tensor(c) for c in cols), width=W, height=H,
        tile_w=tile[0], tile_h=tile[1], max_pairs=MP, compact=False,
        expand_impl=expand_impl, with_ids=with_ids)


def carry_over(jb) -> t_tb.TileBinning:
    """The JAX package's f32 binning as the port's, through NumPy."""
    t = lambda a: torch.as_tensor(np.array(a))
    return t_tb.TileBinning(
        payload=t(np.asarray(jb.payload)[:, :MP].view(np.int32)),
        tile_start=t(jb.tile_start), tile_count=t(jb.tile_count),
        total_pairs=t(jb.total_pairs), overflow=t(jb.overflow))


@pytest.mark.parametrize("expand_impl", ["fused", "pallas"])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_f32_binning_with_ids_matches_jax_bitwise(tile, expand_impl):
    cols = make_columns(seed=tile[0])
    jb = jax_binning(cols, tile, expand_impl)
    tb = port_binning(cols, tile, expand_impl)
    total = int(tb.total_pairs)
    assert 1000 < total < MP and tb.payload.shape == (8, MP)
    np.testing.assert_array_equal(
        tb.payload.numpy(), np.asarray(jb.payload)[:, :MP].view(np.int32))
    assert (tb.payload[7, total:] == MP).all()
    for name in ("tile_start", "tile_count", "total_pairs", "overflow",
                 "sorted_base", "sorted_touched"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    n_live = int((tb.sorted_touched > 0).sum())
    assert 0 < n_live < len(cols[0])
    t_orig, j_orig = tb.sorted_orig.numpy(), np.asarray(jb.sorted_orig)
    np.testing.assert_array_equal(t_orig[:n_live], j_orig[:n_live])
    np.testing.assert_array_equal(np.sort(t_orig[n_live:]),
                                  np.sort(j_orig[n_live:]))


def test_f32_binning_without_ids_and_overflow():
    cols = make_columns(seed=3)
    jb = jax_binning(cols, (16, 16), with_ids=False)
    tb = port_binning(cols, (16, 16), with_ids=False)
    np.testing.assert_array_equal(
        tb.payload.numpy(), np.asarray(jb.payload)[:, :MP].view(np.int32))
    assert tb.sorted_base is None and tb.sorted_orig is None
    # the plain expansion ("xla") gives the same stream on the CPU
    xb = port_binning(cols, (16, 16), "xla", with_ids=False)
    assert torch.equal(xb.payload, tb.payload)
    # a buffer smaller than the view: flagged, segments clamped into it
    small = t_tb.build_tile_binning(
        *(torch.as_tensor(c) for c in cols), width=W, height=H, tile_w=16,
        tile_h=16, max_pairs=512, compact=False)
    assert bool(small.overflow) and int(small.tile_start[-1]) == 512
    # ellipse spans bin the f32 stream too (a subset of its rect pairs;
    # held against the JAX package in tests/test_torch_ellipse.py), but
    # forward only: no gradient-routing ids
    eb = t_tb.build_tile_binning(
        *(torch.as_tensor(c) for c in cols), width=W, height=H, tile_w=16,
        tile_h=16, max_pairs=MP, compact=False, span_mode="ellipse")
    assert (eb.tile_count <= tb.tile_count).all()
    assert 0 < int(eb.total_pairs) < int(tb.total_pairs)
    with pytest.raises(ValueError, match="forward only"):
        t_tb.build_tile_binning(
            *(torch.as_tensor(c) for c in cols), width=W, height=H,
            compact=False, span_mode="ellipse", with_ids=True)
    with pytest.raises(ValueError):
        t_tb.build_tile_binning(
            *(torch.as_tensor(c) for c in cols), width=W, height=H,
            compact=True, with_ids=True)


def test_pack15_matches_jax_bitwise():
    rng = np.random.default_rng(8)
    x = rng.uniform(-0.5, 4.5, 4096).astype(np.float32)
    y = rng.uniform(0, 1, 4096).astype(np.float32)
    x[:4] = [0.0, 3.99999, 4.0, 1.0 / 8191.75]
    got = t_tb.pack15(torch.as_tensor(x), torch.as_tensor(y))
    want = np.asarray(j_tb.pack15(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    hi, lo = t_tb.unpack15(got)
    step = 4 / 32767
    assert float((hi - torch.as_tensor(x).clamp(0, 4)).abs().max()) <= step
    assert float((lo - torch.as_tensor(y)).abs().max()) <= step


@pytest.fixture(scope="module")
def blend_binnings():
    """The JAX package's binning of the blend tests' 60 splats, one a tile
    shape, shared by the cases that blend it."""
    return {tile: jax_binning(make_columns(seed=11, n=60), tile)
            for tile in ((16, 16), (32, 16))}


@pytest.mark.parametrize("skip_range_check", [True, False])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_blend_subtiles_matches_jax(blend_binnings, tile, skip_range_check):
    _blend_subtiles_matches_jax(blend_binnings[tile], tile, skip_range_check,
                                False)


@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_blend_subtiles_lut_matches_jax(blend_binnings, tile):
    # the LUT chord sits above exp: with it the range test stays on
    _blend_subtiles_matches_jax(blend_binnings[tile], tile, False, True)


def _blend_subtiles_matches_jax(jb, tile, skip_range_check, use_exp_lut):
    kw = dict(width=W, height=H, sub_w=tile[0], sub_h=tile[1], chunk=128,
              skip_range_check=skip_range_check, use_exp_lut=use_exp_lut,
              **BLEND)
    jc, jt = j_sub.blend_subtiles(jb, interpret=True, **kw)
    tc, tt = t_sub.blend_subtiles(carry_over(jb), **kw)
    assert tc.shape == (H, W, 3) and tt.shape == (H, W)
    assert 0.02 < float(tt.mean()) < 0.98
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


def test_blend_subtiles_stops_at_chunk_boundary():
    # three clamped opaque splats in front leave trans = 1e-6 everywhere,
    # so each tile blends its first 128-pair chunk and skips the rest
    jb = jax_binning(make_columns(seed=12, n=900, wall_rank=0), (16, 16))
    assert int(np.asarray(jb.tile_count).min()) > 128
    kw = dict(width=W, height=H, sub_w=16, sub_h=16, chunk=128,
              skip_range_check=True, **BLEND)
    jc, jt = j_sub.blend_subtiles(jb, interpret=True, **kw)
    stats = {}
    tc, tt = t_sub.blend_subtiles_plain(carry_over(jb), stats=stats, **kw)
    assert stats["pairs_blended"] == 128 * 12
    assert float(tt.max()) <= 1e-4
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    # without the stop the later pairs would go on lowering trans
    _, full = t_sub.blend_subtiles_plain(carry_over(jb), **{
        **kw, "term_eps": 0.0})
    assert bool((full < tt).any())


def test_blend_subtiles_validates_inputs():
    tb = port_binning(make_columns(seed=1), (16, 16))
    kw = dict(width=W, height=H, sub_w=16, sub_h=16)
    with pytest.raises(TypeError):
        t_sub.blend_subtiles(tb._replace(payload=tb.payload.float()), **kw)
    with pytest.raises(ValueError):
        t_sub.blend_subtiles(tb._replace(payload=tb.payload[:5]), **kw)
    with pytest.raises(ValueError):
        t_sub.blend_subtiles(tb, width=W, height=H, sub_w=32, sub_h=16)


def test_render_tiled_subtile_matches_jax():
    _render_tiled_subtile_matches_jax(False)


def test_render_tiled_subtile_lut_matches_jax():
    _render_tiled_subtile_matches_jax(True)


def _render_tiled_subtile_matches_jax(use_exp_lut):
    jc, jcam = j_random_cloud(200, seed=5, width=W, height=H)
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), W, H, device="cpu")
    kw = dict(width=W, height=H, tile_w=16, tile_h=16, blend_impl="subtile",
              white_background=True, use_exp_lut=use_exp_lut)
    j = j_rt.render_tiled(jc, jcam, JCfg(**kw), max_pairs=MP, interpret=True)
    t = t_rt.render_tiled(c, cam, RenderConfig(**kw), max_pairs=MP)
    assert not bool(t.overflow)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color),
                               atol=1e-4)
    np.testing.assert_allclose(t.trans.numpy(), np.asarray(j.trans),
                               atol=1e-4)
    np.testing.assert_array_equal(t.hits.numpy(), np.asarray(j.hits))
    tr = t_rt.GaussianRayTracer(RenderConfig(**kw), "tiled", device="cpu")
    out = tr(c, cam)        # calibrates the pair buffer for the tile stream
    assert tr.max_rows is None and not bool(out.overflow)
    np.testing.assert_allclose(out.color.numpy(), t.color.numpy(), atol=1e-6)


def test_blend_tiles_matches_jax():
    """The (128, 8)-tile blend (the subtile kernel's function at that
    shape) against the JAX package's round-1 kernel, exp and LUT."""
    from gsrt.ops import splat_pallas as j_pallas

    from gsrt_torch.ops import splat_pallas as t_pallas
    w, h = 256, 32
    cols = make_columns(seed=13, n=300)
    cols[1] = cols[1] * (w / W)              # spread the means over 256 px
    jb = j_tb.build_tile_binning(
        *(jnp.asarray(c) for c in cols), width=w, height=h, tile_w=128,
        tile_h=8, chunk=128, max_pairs=MP, interpret=True)
    tb = carry_over(jb)
    for lut in (False, True):
        kw = dict(width=w, height=h, chunk=128, skip_range_check=not lut,
                  use_exp_lut=lut, **BLEND)
        jc, jt = j_pallas.blend_tiles(jb, interpret=True, **kw)
        tc, tt = t_pallas.blend_tiles(tb, **kw)
        assert 0.02 < float(tt.mean()) < 0.98
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


CULL_RULES = {"skip_range": dict(skip_range_check=True, use_exp_lut=False),
              "range": dict(skip_range_check=False, use_exp_lut=False),
              "range_lut": dict(skip_range_check=False, use_exp_lut=True),
              "skip_range_lut": dict(skip_range_check=True,
                                     use_exp_lut=True)}


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (128, 8)],
                         ids=["16x16", "32x16", "128x8"])
def test_warp_cull_is_exact(tile):
    """The f32 kernels' warp cull, at each tile shape's warp footprints
    (the forward's and the backward's pixels a thread): under every accept
    rule, no (warp, pair) it skips has a pixel that takes the pair, in the
    forward or with the backward's g floored at 0."""
    from gsrt_torch.models import gaussian_rt as t_grt
    from gsrt_torch.ops import splat_grad as t_grad
    from gsrt_torch.ops import splat_packed as t_sp
    from gsrt_torch.scene import random_cloud as t_random_cloud
    tw, th = tile
    w, h = 256, 128
    cfg = RenderConfig(width=w, height=h, tile_w=tw, tile_h=th)
    cloud, cam = t_random_cloud(1500, seed=4, width=w, height=h,
                                scale_range=(0.01, 0.3), device="cpu")
    d, m2, q, inf, col = t_grt._project_sh(cloud, cam, cfg)
    rx, ry = t_grt.screen_extents_abc(q[:, 0], q[:, 1], q[:, 2], "standard",
                                      5.6, opacity=cloud.opacity)
    b = t_tb.build_tile_binning(
        d, m2[:, 0], m2[:, 1], q[:, 0], q[:, 1], q[:, 2], cloud.opacity,
        col[:, 0], col[:, 1], col[:, 2], rx, ry,
        t_grt.alive_mask(d, cloud.opacity, inf, cfg), width=w, height=h,
        tile_w=tw, tile_h=th, max_pairs=1 << 16, compact=False)
    assert not bool(b.overflow)
    ntx, nty = t_tb.tile_extent(w, h, tw, th)
    n = int(b.tile_start[-1])
    f = t_sub.decode_pairs(b.payload[:, :n])
    tiles = torch.repeat_interleave(torch.arange(ntx * nty),
                                    torch.diff(b.tile_start.long()))
    ox, oy = (tiles % ntx * tw).float(), (tiles // ntx * th).float()
    lx, ly = t_sub.tile_pixels(0, 1, tw, th, "cpu")
    feet = []
    for pix in (t_sub.PIXELS_PER_THREAD, t_grad.PIXELS_PER_THREAD):
        owner = t_sub.warp_of_pixel(tw, th, pix, "cpu")
        foot = t_sub.warp_footprint(tw, th, pix, "cpu")
        # the footprint is the bounding box of the pixels each warp holds
        for wi in range(foot[0].numel()):
            mine = owner == wi
            assert [float(v[wi]) for v in foot] == [
                float(ly[mine].min()), float(ly[mine].max()),
                float(lx[mine].min()), float(lx[mine].max())]
        onehot = owner[None, :] == torch.arange(foot[0].numel())[:, None]
        feet.append((pix, foot, onehot.float()))
    dx = lx[:, None] + ox[None, :] - f["mx"][None, :]          # [P, n]
    dy = ly[:, None] + oy[None, :] - f["my"][None, :]
    g = 0.5 * (f["qa"] * dx * dx + 2.0 * f["qb"] * dx * dy
               + f["qc"] * dy * dy)
    in_range = (g >= 0.0) & (g <= BLEND["g_cutoff"])
    for rule, r in CULL_RULES.items():
        kw = dict(BLEND, **r)
        _, fwd = t_sp.alphas(g, f["op"], **kw)
        e = (t_sub.explut.exp_neg_lut if r["use_exp_lut"]
             else lambda x: torch.exp(-x))
        bwd = f["op"][None, :] * e(torch.clamp_min(g, 0.0)) > \
            BLEND["alpha_threshold"]
        if not r["skip_range_check"]:
            bwd = bwd & in_range
        gs = t_sp.skip_bound(f["op"], **kw)
        for pix, foot, onehot in feet:
            cull = t_sub.warp_cull(f, foot, gs, ox, oy)
            for what, accept in (("forward", fwd), ("backward", bwd)):
                reached = (onehot @ accept.float()) > 0        # [warps, n]
                bad = (cull & reached).nonzero()
                assert bad.numel() == 0, (
                    f"{rule}, {pix} px a thread, {what}: the cull skips "
                    f"pairs a pixel takes: (warp, column) "
                    f"{bad[:4].tolist()}")
            # it engages, not everywhere
            assert 0 < int(cull.sum()) < cull.numel(), (rule, pix)
