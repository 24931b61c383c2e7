"""gsrt_torch's ellipse spans (`ops.tile_binning._build_ellipse`,
`span_mode="ellipse"`), their NumPy sizing (`count_rows_pairs_numpy`,
`GaussianRayTracer.calibrate`) and renders, held against the JAX package
on the same NumPy inputs (CPU; the JAX blend in interpret mode with
math_dtype="f32").

Tolerances:
  * binning, every expand the port has for the payload: tile_start,
    tile_count, total_pairs and overflow exact; the compact payload's rows
    0-3 and pair_depth bit for bit on live columns, its tile row
    everywhere; the f32 payload bit for bit (the JAX package's depth sort
    is unstable where the port's is stable: the scenes have no equal
    depths). Against the port's rect spans: every (tile, splat) pair of
    the ellipse stream is one of the rect stream's, and no tile has more;
  * renders: atol 1e-4 against the JAX package's f32 blend (as the rect
    tile streams in tests/test_torch_render.py), atol 1e-6 against the
    port's own rect render (the pairs left out are taken by no pixel);
  * `count_rows_pairs_numpy`: equal to the JAX package's, and within 1%
    of the binning's pairs and rows (its float64 against the binning's
    f32, as tests/test_ellipse_spans.py:57-59 allows).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import gaussian_rt as j_rt
from gsrt.ops import tile_binning as j_tb
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import RenderConfig
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import tile_binning as t_tb
from test_torch_render import _port
from test_torch_tilestream import H, MP, NTY, TH, TW, W, scene_columns

MR = 1 << 12
EXPANDS = {True: ["fused", "binned", "xla"], False: ["fused", "pallas",
                                                     "xla"]}
_JAX: dict = {}


@pytest.fixture(scope="module")
def sparse():
    return scene_columns("sparse")


def jax_binning(cols, compact, max_rows=MR):
    """The JAX package's ellipse tile stream (its plain expand: the Pallas
    expands give the same stream, tests/test_ellipse_spans.py)."""
    key = (id(cols), compact, max_rows)
    if key not in _JAX:
        _JAX[key] = j_tb.build_tile_binning(
            *(jnp.asarray(c) for c in cols), width=W, height=H, tile_w=TW,
            tile_h=TH, chunk=384, max_pairs=MP, expand_impl="xla",
            compact=compact, stream="tile", span_mode="ellipse",
            max_rows=max_rows, carry_depth=True)
    return _JAX[key]


def port_binning(cols, compact, expand_impl="fused", max_rows=MR,
                 span_mode="ellipse"):
    return t_tb.build_tile_binning(
        *(torch.as_tensor(np.array(c)) for c in cols), width=W, height=H,
        tile_w=TW, tile_h=TH, max_pairs=MP, compact=compact, stream="tile",
        span_mode=span_mode, max_rows=max_rows, expand_impl=expand_impl,
        carry_depth=True)


def _pair_keys(b, T):
    """(tile << 32 | mean-x bits) of each live pair of an f32 stream: one
    key per (tile, splat)."""
    pay = b.payload.numpy()
    live = pay[7, :int(b.total_pairs)] & 0xFFFFF
    return (live.astype(np.int64) << 32) | (
        pay[0, :live.shape[0]].astype(np.int64) & 0xFFFFFFFF)


@pytest.mark.parametrize("case", [(c, e) for c in (True, False)
                                  for e in EXPANDS[c]],
                         ids=lambda c: f"{'compact' if c[0] else 'f32'}-"
                         f"{c[1]}")
def test_ellipse_binning_matches_jax(sparse, case):
    compact, expand_impl = case
    jb = jax_binning(sparse, compact)
    tb = port_binning(sparse, compact, expand_impl)
    for name in ("tile_start", "tile_count", "total_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    total = int(tb.total_pairs)
    T = tb.tile_count.numel()
    rect = port_binning(sparse, compact, span_mode="rect")
    assert 1000 < total < int(rect.total_pairs)
    assert (tb.tile_count <= rect.tile_count).all()
    np.testing.assert_array_equal(tb.pair_depth.numpy()[:total],
                                  np.asarray(jb.pair_depth)[:total])
    if compact:
        jp = np.asarray(jb.payload)[:5, :MP]
        tp = tb.payload.numpy()
        np.testing.assert_array_equal(tp[:4, :total], jp[:4, :total])
        np.testing.assert_array_equal(tp[4], jp[4])
    else:
        np.testing.assert_array_equal(
            tb.payload.numpy(),
            np.asarray(jb.payload)[:, :MP].view(np.int32))
        assert np.isin(_pair_keys(tb, T), _pair_keys(rect, T)).all()


@pytest.mark.parametrize("payload", ["compact", "f32"])
def test_ellipse_render_matches_jax(payload):
    jc, jcam = j_random_cloud(1500, seed=3, width=128, height=96,
                              scale_range=(0.02, 0.12))
    c, cam = _port(jc, jcam)
    kw = dict(width=128, height=96, tile_w=16, tile_h=16, stream="tile",
              span_mode="ellipse", payload=payload)
    j = j_rt.render_tiled(jc, jcam, JCfg(blend_math="f32", **kw),
                          max_pairs=MP, max_rows=MR, interpret=True)
    tracer = t_rt.GaussianRayTracer(RenderConfig(**kw), "tiled",
                                    device="cpu")
    t = tracer(c, cam)
    assert not bool(t.overflow) and not bool(j.overflow)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color),
                               atol=1e-4)
    np.testing.assert_allclose(t.trans.numpy(), np.asarray(j.trans),
                               atol=1e-4)
    np.testing.assert_array_equal(t.hits.numpy(), np.asarray(j.hits))
    rect = t_rt.render_tiled(c, cam, RenderConfig(**{**kw,
                                                     "span_mode": "rect"}),
                             max_pairs=MP)
    np.testing.assert_allclose(t.color.numpy(), rect.color.numpy(),
                               atol=1e-6)
    assert (t.hits <= rect.hits).all() and t.hits.sum() < rect.hits.sum()


def test_count_rows_pairs_numpy(sparse):
    """The host count against the JAX package's and the binning's."""
    jc, jcam = j_random_cloud(1200, seed=3, width=W, height=H,
                              scale_range=(0.02, 0.12))
    c, cam = _port(jc, jcam)
    kw = dict(width=W, height=H, tile_w=TW, tile_h=TH, span_mode="ellipse")
    pairs, rows = t_rt.count_rows_pairs_numpy(c, cam, RenderConfig(**kw))
    assert (pairs, rows) == j_rt.count_rows_pairs_numpy(jc, jcam, JCfg(**kw))
    # the same scene as `sparse`, binned: the rows exactly (a buffer one
    # row short overflows), the pairs within 1%
    tb = port_binning(sparse, True, max_rows=rows)
    assert not bool(tb.overflow)
    assert bool(port_binning(sparse, True, max_rows=rows - 1).overflow)
    assert abs(pairs - int(tb.total_pairs)) <= 0.01 * pairs


@pytest.mark.parametrize("payload", ["compact", "f32"])
def test_ellipse_row_overflow(sparse, payload):
    """A row buffer smaller than the view's rows: flagged, as in the JAX
    package, and every segment clamped inside the pair buffer."""
    compact = payload == "compact"
    jb = jax_binning(sparse, compact, max_rows=256)
    tb = port_binning(sparse, compact, max_rows=256)
    assert bool(tb.overflow) and bool(jb.overflow)
    np.testing.assert_array_equal(tb.tile_count.numpy(),
                                  np.asarray(jb.tile_count))
    assert int(tb.tile_start[-1]) <= MP


def test_calibrate_sizes_ellipse_rows():
    """calibrate sizes the row buffer from count_rows_pairs_numpy, and the
    render needs no re-render; past 255 tile rows the same config falls
    back to rect spans for both."""
    jc, jcam = j_random_cloud(800, seed=4, width=96, height=64)
    c, cam = _port(jc, jcam)
    cfg = RenderConfig(width=96, height=64, tile_w=16, tile_h=16,
                       span_mode="ellipse")
    tr = t_rt.GaussianRayTracer(cfg, "tiled", device="cpu")
    tr.calibrate(c, cam)
    pairs, rows = t_rt.count_rows_pairs_numpy(c, cam, cfg)
    assert tr.max_rows == t_rt.pair_bucket(int(rows * 1.1))
    assert tr.max_pairs == t_rt.pair_bucket(int(pairs * 1.1))
    out = tr(c, cam)
    assert not bool(out.overflow)
    ref = t_rt.render_fast(c, cam, cfg)
    np.testing.assert_allclose(out.color.numpy(), ref.color.numpy(),
                               atol=2e-2)
    tall = cfg.replace(tile_h=1, height=256)     # 256 tile rows
    assert t_rt.stream_plan(tall, 96, 256).span_mode == "rect"
    assert t_rt.stream_plan(cfg, 96, 64).span_mode == "ellipse"
    with pytest.raises(ValueError, match="255"):
        t_tb.build_tile_binning(
            *(torch.zeros(4) for _ in range(12)), torch.ones(4, dtype=bool),
            width=96, height=256, tile_w=16, tile_h=1, span_mode="ellipse")


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_ellipse_row_tiles_keep_every_taking_pixel(kind):
    """`ellipse_row_tiles` leaves a tile out of a splat's tile row only
    where no pixel of it takes the splat in f32 (the blend's accept rule
    with the range test): every (pixel, splat) the blend takes lies in
    the splat's box and its row's ellipse span, and the spans leave out
    some of the box."""
    from gsrt_torch.ops.splat_packed import alphas, response
    (depth, m2x, m2y, qa, qb, qc, opacity, cr, cg, cb, rx, ry,
     alive) = (torch.as_tensor(np.array(c)) for c in scene_columns(kind))
    x0, x1, y0, y1, touched = t_tb.compute_tile_spans(
        m2x, m2y, rx, ry, alive, W, H, TW, TH)
    op = torch.where(alive, opacity, torch.zeros_like(opacity))
    n = (touched > 0).nonzero()[:, 0]
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    g = response(dict(mx=m2x[n], my=m2y[n], qa=qa[n], qb=qb[n], qc=qc[n]),
                 xs.flatten(), ys.flatten())                 # [P, n]
    _, take = alphas(g, op[n], g_cutoff=5.6, alpha_threshold=1.0 / 255.0,
                     alpha_clamp=0.99, skip_range_check=False,
                     use_exp_lut=False)
    e0, e1 = t_tb.ellipse_row_tiles(
        *(a[n][None, :].expand(NTY, -1) for a in (m2x, m2y, qa, qb, qc,
                                                   op)),
        torch.arange(NTY, dtype=torch.int32)[:, None].expand(-1, n.numel()),
        *(a[n][None, :].expand(NTY, -1) for a in (x0, x1)), tile_w=TW,
        tile_h=TH, g_cutoff=5.6, alpha_threshold=1.0 / 255.0)  # [NTY, n]
    ty = (ys.flatten() // TH).long()
    tx = (xs.flatten() // TW).int()[:, None]
    inside = ((y0[n] <= ty[:, None]) & (ty[:, None] <= y1[n])
              & (e0[ty] <= tx) & (tx <= e1[ty]))
    assert take.any() and not (take & ~inside).any()
    rows = (torch.arange(NTY)[:, None] >= y0[n]) \
        & (torch.arange(NTY)[:, None] <= y1[n])
    kept = torch.where(rows, e1 - e0 + 1, 0).sum()
    boxed = ((x1 - x0 + 1) * (y1 - y0 + 1))[n].sum()
    assert 0 < kept < boxed
