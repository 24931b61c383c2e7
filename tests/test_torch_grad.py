"""gsrt_torch blend backward (`ops/splat_grad.py`) and the differentiable
tiled render (`models/tiled_diff.py`) against the JAX package on the same
NumPy inputs (CPU; JAX Pallas kernels in interpret mode).

Tolerances:
  * blend_backward: each of the nine gradient rows divided by the row's
    largest magnitude, atol 1e-4 — the same f32 formulas, but the JAX
    kernel takes the transmittance and the prefix colour of a chunk with
    doubling scans where the port walks pair by pair, and both difference
    a final colour against a prefix (cancellation near a tile's end);
  * render_tiled_diff forward: atol 1e-4 (projection and SH reassociate
    between XLA and PyTorch);
  * its gradients, each divided by its largest magnitude: atol 2e-3
    against the JAX package's tiled gradients and against the port's own
    render_fast under autograd, the bound tests/test_tiled_diff.py holds
    the JAX package to (pack15 quantises colour and opacity to 1.2e-4, and
    the JAX routing differences f32 prefix sums where the port uses f64).
The CUDA kernels are held against the plain versions in
tests/test_torch_gpu.py, which needs a card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import tiled_diff as j_td
from gsrt.ops import splat_grad as j_grad
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import GaussianCloud, RenderConfig
from gsrt_torch.interop import camera_from_numpy, cloud_from_numpy
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.models import tiled_diff as t_td
from gsrt_torch.ops import splat_grad as t_grad
from gsrt_torch.ops import splat_subtile as t_sub
from gsrt_torch.ops import tile_binning as t_tb

from test_torch_subtile import BLEND, H, MP, W, carry_over, jax_binning, \
    make_columns


def _pixstate(tb, tile, rng, **kw):
    """The forward's colour and transmittance with random cotangents,
    tile-major: [8, T * tile_w * tile_h]."""
    color, trans = t_sub.blend_subtiles_plain(tb, **kw)
    dcolor = torch.as_tensor(rng.normal(size=(H, W, 3)).astype(np.float32))
    dtrans = torch.as_tensor(rng.normal(size=(H, W)).astype(np.float32))
    planes = [color[..., 0], color[..., 1], color[..., 2], trans,
              dcolor[..., 0], dcolor[..., 1], dcolor[..., 2], dtrans]
    return torch.stack([t_td.tilefy(p, *tile) for p in planes])


def _assert_rows_close(got, want, atol):
    for r in range(9):
        scale = np.abs(want[r]).max()
        assert scale > 0, f"row {r} of the reference is all zero"
        np.testing.assert_allclose(got[r] / scale, want[r] / scale,
                                   atol=atol, err_msg=f"gradient row {r}")


@pytest.fixture(scope="module")
def backward_binnings():
    """The JAX package's binning of the backward tests' 60 splats, one a
    tile shape, shared by the cases that differentiate it."""
    return {tile: jax_binning(make_columns(seed=21, n=60), tile)
            for tile in ((16, 16), (32, 16), (128, 8))}


@pytest.mark.parametrize("skip_range_check", [True, False])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16)])
def test_blend_backward_matches_jax(backward_binnings, tile,
                                    skip_range_check):
    _blend_backward_matches_jax(backward_binnings[tile], tile,
                                skip_range_check, False)


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (128, 8)])
def test_blend_backward_lut_matches_jax(backward_binnings, tile):
    # the LUT's derivative is its segment's slope; the range test stays on
    _blend_backward_matches_jax(backward_binnings[tile], tile, False, True)


def _blend_backward_matches_jax(jb, tile, skip_range_check, use_exp_lut):
    tb = carry_over(jb)
    size = dict(width=W, height=H, chunk=128,
                skip_range_check=skip_range_check, use_exp_lut=use_exp_lut,
                **BLEND)
    pix = _pixstate(tb, tile, np.random.default_rng(5), sub_w=tile[0],
                    sub_h=tile[1], **size)
    kw = dict(tile_w=tile[0], tile_h=tile[1], **size)
    jg = np.asarray(j_grad.blend_backward(
        jb.payload, jb.tile_start, jnp.asarray(pix.numpy()), interpret=True,
        **kw))
    tg = t_grad.blend_backward(tb.payload, tb.tile_start, pix, **kw)
    assert tg.shape == (9, MP)
    assert not (jg[9:] != 0).any() and not (jg[:, MP:] != 0).any()
    _assert_rows_close(tg.numpy(), jg[:9, :MP], atol=1e-4)
    total = int(tb.total_pairs)
    assert not (tg[:, total:] != 0).any()


def test_blend_backward_clamped_alpha_and_stopped_tiles():
    # 40 ordinary splats, then three that cover the image at a clamped
    # alpha: trans falls to 1e-6, so each tile blends the rest of its first
    # 128-pair chunk and neither blends nor differentiates anything behind
    tile = (16, 16)
    jb = jax_binning(make_columns(seed=22, n=900, wall_rank=40), tile)
    tb = carry_over(jb)
    ts = tb.tile_start.tolist()
    assert min(b - a for a, b in zip(ts, ts[1:])) > 128
    op = t_sub.decode_pairs(tb.payload[:, :ts[-1]])["op"]
    assert int((op > BLEND["alpha_clamp"]).sum()) == 3 * 12   # clamped
    size = dict(width=W, height=H, chunk=128, skip_range_check=True, **BLEND)
    pix = _pixstate(tb, tile, np.random.default_rng(6), sub_w=16, sub_h=16,
                    **size)
    assert float(pix[3].max()) <= 1e-4                          # stopped
    kw = dict(tile_w=16, tile_h=16, **size)
    jg = np.asarray(j_grad.blend_backward(
        jb.payload, jb.tile_start, jnp.asarray(pix.numpy()), interpret=True,
        **kw))[:9, :MP]
    tg = t_grad.blend_backward(tb.payload, tb.tile_start, pix, **kw).numpy()
    _assert_rows_close(tg, jg, atol=1e-4)
    for a, b in zip(ts, ts[1:]):
        assert np.abs(tg[:, a:a + 128]).max() > 0
        assert not (tg[:, a + 128:b] != 0).any()
        assert not (jg[:, a + 128:b] != 0).any()
    # a clamped pair passes no gradient to its conic, mean or opacity, but
    # its colour still does
    clamped = (op > BLEND["alpha_clamp"]).numpy()
    assert not (tg[:6, :ts[-1]][:, clamped] != 0).any()
    assert np.abs(tg[6:, :ts[-1]][:, clamped]).max() > 0


def test_blend_backward_validates_inputs():
    tb = carry_over(jax_binning(make_columns(seed=1, n=30), (16, 16)))
    kw = dict(width=W, height=H, tile_w=16, tile_h=16, chunk=128, **BLEND)
    pix = torch.zeros((8, 12 * 256))
    assert t_grad.blend_backward(tb.payload, tb.tile_start, pix,
                                 **kw).abs().max() == 0
    with pytest.raises(ValueError, match="pixstate"):
        t_grad.blend_backward(tb.payload, tb.tile_start, pix[:, :-1], **kw)
    # the LUT is ported: zero cotangents give zero gradients in it too
    assert t_grad.blend_backward(tb.payload, tb.tile_start, pix,
                                 use_exp_lut=True, **kw).abs().max() == 0


def test_route_pair_grads_sums_each_splats_pairs():
    cols = make_columns(seed=23, n=200)
    tb = t_tb.build_tile_binning(
        *(torch.as_tensor(c) for c in cols), width=W, height=H, tile_w=16,
        tile_h=16, max_pairs=MP, compact=False, with_ids=True)
    rng = np.random.default_rng(7)
    total = int(tb.total_pairs)
    grad = np.zeros((9, MP), np.float32)
    grad[:, :total] = rng.normal(size=(9, total))
    out = t_td.route_pair_grads(torch.as_tensor(grad), tb.payload[7],
                                tb.sorted_base, tb.sorted_touched,
                                tb.sorted_orig).numpy()
    # each column's splat, by brute force: depth-order pair index -> the
    # depth-sorted splat whose run holds it -> its original index
    idp = tb.payload[7, :total].numpy()
    base, orig = tb.sorted_base.numpy(), tb.sorted_orig.numpy()
    n_live = int((tb.sorted_touched > 0).sum())
    splat = orig[np.searchsorted(base[:n_live], idp, side="right") - 1]
    want = np.zeros((9, len(cols[0])), np.float64)
    np.add.at(want.T, splat, grad[:, :total].T.astype(np.float64))
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    assert not (out[:, ~cols[12]] != 0).any()      # culled splats: zeros


W_C = np.random.default_rng(9).normal(size=(H, W, 3)).astype(np.float32)
W_T = np.random.default_rng(10).normal(size=(H, W)).astype(np.float32)


def _port_grads(fn, cloud):
    leaf = GaussianCloud(*(t.clone().requires_grad_() for t in cloud))
    color, trans = fn(leaf)
    loss = (color * torch.as_tensor(W_C)).sum() \
        + (trans * torch.as_tensor(W_T)).sum()
    loss.backward()
    return color.detach(), trans.detach(), \
        {k: getattr(leaf, k).grad.numpy() for k in cloud._fields}


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (128, 8)])
def test_render_tiled_diff_matches_jax_and_render_fast(tile):
    _render_tiled_diff_matches(tile)


@pytest.mark.parametrize("tile", [(16, 16), (128, 8)])
def test_render_tiled_diff_lut_matches_jax_and_render_fast(tile):
    _render_tiled_diff_matches(tile, use_exp_lut=True)


def _render_tiled_diff_matches(tile, **cfg_kw):
    jc, jcam = j_random_cloud(200, seed=5, width=W, height=H)
    # three splats behind the camera: culled, and their gradients must be 0
    means = np.array(jc.means)
    means[:3, 2] = -3.0
    jc = jc._replace(means=jnp.asarray(means))
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), W, H, device="cpu")
    kw = dict(width=W, height=H, conic_mode="standard", tile_w=tile[0],
              tile_h=tile[1], pair_chunk=128, **cfg_kw)
    jcfg, cfg = JCfg(**kw), RenderConfig(**kw)

    def j_loss(cl):
        color, trans = j_td.render_tiled_diff(cl, jcam, jcfg, max_pairs=MP,
                                              interpret=True)
        return jnp.sum(color * W_C) + jnp.sum(trans * W_T), (color, trans)

    (_, (j_color, j_trans)), j_g = jax.value_and_grad(j_loss, has_aux=True)(
        jc)
    color, trans, t_g = _port_grads(
        lambda cl: t_td.render_tiled_diff(cl, cam, cfg, MP), c)
    np.testing.assert_allclose(color.numpy(), np.asarray(j_color), atol=1e-4)
    np.testing.assert_allclose(trans.numpy(), np.asarray(j_trans), atol=1e-4)

    def fast(cl):
        out = t_rt.render_fast(cl, cam, cfg)
        return out.color, out.trans
    _, _, f_g = _port_grads(fast, c)

    for name in ("means", "cov3d", "opacity", "sh"):
        got = t_g[name]
        assert np.isfinite(got).all(), name
        assert not (got[:3] != 0).any(), f"culled splats, {name}"
        for ref, what in ((np.asarray(getattr(j_g, name)), "gsrt tiled"),
                          (f_g[name], "render_fast autograd")):
            scale = np.abs(ref).max() + 1e-8
            np.testing.assert_allclose(
                got / scale, ref / scale, atol=2e-3,
                err_msg=f"{name} against {what}, tile {tile}")


def test_render_tiled_diff_raises_on_overflow_and_unported_tiles():
    jc, jcam = j_random_cloud(200, seed=5, width=W, height=H)
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), W, H, device="cpu")
    cfg = RenderConfig(width=W, height=H, tile_w=16, tile_h=16)
    with pytest.raises(RuntimeError, match="max_pairs"):
        t_td.render_tiled_diff(c, cam, cfg, max_pairs=256)
    # (128, 8) tiles train through blend_tiles (held against the JAX
    # package in test_render_tiled_diff_matches_jax_and_render_fast)
    _, _, g128 = _port_grads(
        lambda cl: t_td.render_tiled_diff(
            cl, cam, cfg.replace(tile_w=128, tile_h=8), MP), c)
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0
               for g in g128.values())
    # a clipped colour still passes its gradient (straight-through pack15)
    hot = c._replace(sh=c.sh * 0 + 20.0)
    _, _, g = _port_grads(lambda cl: t_td.render_tiled_diff(cl, cam, cfg, MP),
                          hot)
    assert np.abs(g["sh"][:, 0]).max() > 0
