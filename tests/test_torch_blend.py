"""gsrt_torch group-stream blend (`ops/splat_packed.py`) against the JAX
package's packed Pallas kernel (interpret mode, CPU) on the SAME compact
payload: the JAX package's group-stream binning, with its five live rows
handed to the port.

Tolerance: atol 2e-3 on color and trans, the JAX suite's own bound
between blend formulations (tests/test_group_stream.py:52-55); the JAX
kernel runs math_dtype="f32". The port stops a tile per batch of BATCH of
its own pairs where the JAX kernel stops per chunk of the group's columns:
either drops only pairs behind trans < term_eps. The CUDA kernels are held
against the plain versions in tests/test_torch_gpu.py, which needs a card.

Also here, port only: the plain partition of the group stream against a
per-group stable sort of the tile ids (exact, also on a stream clamped at
max_pairs), and the kernels' row cull against the plain accept rule: no
(warp, pair) step it skips has a pixel that takes the pair.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models.gaussian_rt import _precompute_fm, fm_from_cloud
from gsrt.ops.gaussian import screen_extents_abc
from gsrt.ops.splat_packed import blend_packed as j_blend
from gsrt.ops.tile_binning import build_tile_binning, group_rows_k
from gsrt.scene.catalog import random_cloud

from gsrt_torch import RenderConfig
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import splat_packed as t_sp
from gsrt_torch.ops import tile_binning as t_tb
from gsrt_torch.ops.tile_binning import TileBinning
from gsrt_torch.scene import random_cloud as t_random_cloud

W = H = 256
TW, TH = 32, 16
NTX = W // TW
BS = group_rows_k(NTX) * NTX     # 16 tile rows: one group of 128 tiles
KW = dict(g_cutoff=5.6, alpha_threshold=1.0 / 255.0, alpha_clamp=0.99,
          skip_range_check=True)


def _jax_binning(n, seed, scale_range, max_pairs=1 << 16):
    cloud, camera = random_cloud(n, seed=seed, width=W, height=H,
                                 scale_range=scale_range)
    cfg = JCfg(width=W, height=H)
    fm = fm_from_cloud(cloud)
    depth, m2x, m2y, qa, qb, qc, inf, cr, cg, cb = _precompute_fm(
        fm, camera, cfg)
    rx, ry = screen_extents_abc(qa, qb, qc, "standard", cfg.g_cutoff,
                                opacity=fm.opacity)
    alive = inf & (fm.opacity > cfg.alpha_threshold) & (depth > cfg.t_min) \
        & (depth < cfg.t_max)
    jb = build_tile_binning(
        depth, m2x, m2y, qa, qb, qc, fm.opacity, cr, cg, cb, rx, ry, alive,
        width=W, height=H, tile_w=TW, tile_h=TH, chunk=cfg.pair_chunk,
        max_pairs=max_pairs, expand_impl="fused", interpret=True,
        compact=True, max_rows=1 << 14, stream="group")
    assert not bool(jb.overflow)
    t = lambda a: torch.as_tensor(np.array(a))
    tb = TileBinning(payload=t(np.asarray(jb.payload)[:5, :max_pairs]),
                     tile_start=t(jb.tile_start), tile_count=t(jb.tile_count),
                     total_pairs=t(jb.total_pairs), overflow=t(jb.overflow))
    return jb, tb


def _jax_blend(jb, math_dtype="f32", **kw):
    color, trans = j_blend(
        jb, width=W, height=H, sub_w=TW, sub_h=TH, bs=BS, group_stream=True,
        interpret=True, scan_impl="logmm", math_dtype=math_dtype,
        chunk=384, **{**KW, **kw})
    return np.asarray(color), np.asarray(trans)


@pytest.fixture(scope="module")
def sparse():
    return _jax_binning(3000, 0, (0.02, 0.25))


@pytest.fixture(scope="module")
def dense():
    # large opaque splats: most tiles saturate and stop early
    return _jax_binning(1500, 4, (0.15, 0.45))


@pytest.mark.parametrize("scene", ["sparse", "dense"])
def test_blend_matches_jax_on_same_payload(scene, request):
    jb, tb = request.getfixturevalue(scene)
    jc, jt = _jax_blend(jb)
    tc, tt = t_sp.blend_packed(tb, width=W, height=H, sub_w=TW, sub_h=TH,
                               bs=BS, **KW)
    assert tc.shape == (H, W, 3) and tt.shape == (H, W)
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-3)
    np.testing.assert_allclose(tt.numpy(), jt, atol=2e-3)


def test_blend_lut_matches_jax_on_same_payload(dense):
    # the LUT chord sits above exp: with it the range test stays on
    jb, tb = dense
    lut = dict(use_exp_lut=True, skip_range_check=False)
    jc, jt = _jax_blend(jb, **lut)
    tc, tt = t_sp.blend_packed(tb, width=W, height=H, sub_w=TW, sub_h=TH,
                               bs=BS, **{**KW, **lut})
    np.testing.assert_allclose(tc.numpy(), jc, atol=2e-3)
    np.testing.assert_allclose(tt.numpy(), jt, atol=2e-3)


def test_early_stop_bound_and_work(dense):
    _, tb = dense
    kw = dict(width=W, height=H, sub_w=TW, sub_h=TH, bs=BS, **KW)
    stats, full_stats = {}, {}
    c, t = t_sp.blend_packed_plain(tb, term_eps=1e-4, stats=stats, **kw)
    cf, tf = t_sp.blend_packed_plain(tb, term_eps=0.0, stats=full_stats,
                                     **kw)
    total = int(tb.total_pairs)
    assert full_stats["pairs_blended"] == total
    assert stats["pairs_blended"] < total          # the stop engaged
    # what the stop drops is weighted by trans < term_eps: colors <= 4
    assert (c - cf).abs().max().item() <= 4e-4
    assert (t - tf).abs().max().item() <= 1e-4


def test_decode_pairs_matches_packers():
    from gsrt_torch.ops import tile_binning as tb
    rng = np.random.default_rng(0)
    mx = torch.as_tensor(rng.uniform(-60, 60, 64).astype(np.float32))
    my = torch.as_tensor(rng.uniform(-60, 60, 64).astype(np.float32))
    l11, l21, l22, depth = (torch.as_tensor(
        rng.uniform(0.05, 2, 64).astype(np.float32)) for _ in range(4))
    rgb = torch.as_tensor(rng.uniform(0, 1, (3, 64)).astype(np.float32))
    op = torch.as_tensor(rng.uniform(0, 1, 64).astype(np.float32))
    cols = torch.stack([tb.pack_mean_rel(mx, my),
                        tb.pack_bf16_pair(l11, l21),
                        tb.pack_bf16_pair(l22, depth),
                        tb.pack_rgba8(*rgb, op),
                        torch.zeros(64, dtype=torch.int32)])
    f = t_sp.decode_pairs(cols)
    np.testing.assert_allclose(f["mx"], mx, atol=1 / 512)
    np.testing.assert_allclose(f["my"], my, atol=1 / 512)
    rh = 0.7071067811865476
    for got, want in ((f["l11"], l11), (f["l21"], l21), (f["l22"], l22)):
        np.testing.assert_allclose(got / rh, want, rtol=2 ** -8)
    np.testing.assert_allclose(f["rgb"].T, rgb, atol=1 / 254 + 1e-6)
    np.testing.assert_allclose(f["op"], op, atol=1 / 510 + 1e-6)


def test_blend_rejects_unported_modes(sparse):
    # the LUT and the tile stream are ported; saturation tracking on the
    # group stream is not (serving reads the tile stream), nor a group
    # that is not whole tile rows or a payload of another width
    _, tb = sparse
    kw = dict(width=W, height=H, sub_w=TW, sub_h=TH, bs=BS)
    with pytest.raises(ValueError, match="group stream"):
        t_sp.blend_packed(tb, track_consumed=True, **kw)
    c, t, hits = t_sp.blend_packed(tb, use_exp_lut=True, track_hits=True,
                                   **kw)
    assert hits.dtype == torch.int32 and int(hits.max()) > 0
    with pytest.raises(ValueError):
        t_sp.blend_packed(tb._replace(payload=tb.payload[:4].contiguous()),
                          **kw)
    with pytest.raises(ValueError):
        t_sp.blend_packed(tb, **{**kw, "bs": NTX + 1})


def _clamped(tb, keep=0.7):
    """The stream binning hands over when max_pairs cuts it: the columns
    past the cap are missing and tile_start is clamped there."""
    cap = int(int(tb.total_pairs) * keep)
    return tb._replace(payload=tb.payload[:, :cap].contiguous(),
                       tile_start=torch.clamp_max(tb.tile_start, cap))


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("scene", ["sparse", "dense"])
def test_partition_plain_is_group_stable_sort(scene, clamp, request):
    tb = request.getfixturevalue(scene)[1]
    if clamp:
        tb = _clamped(tb)
    T = NTX * (H // TH)
    order, seg = t_sp.partition_group_stream(tb, T, BS)
    ts = tb.tile_start.tolist()
    want_seg = []
    for g0 in range(0, T, BS):
        g1 = min(g0 + BS, T)
        a, e = ts[g0], ts[g1]
        tiles = tb.payload[4, a:e]
        ref = torch.sort(tiles, stable=True)
        assert torch.equal(order[a:e], (ref.indices + a).to(torch.int32))
        want_seg += (a + torch.searchsorted(
            ref.values, torch.arange(g0, g1, dtype=torch.int32))).tolist()
    assert seg.tolist() == want_seg + [ts[T]]
    if not clamp:
        assert torch.equal(seg, tb.tile_start)
    else:
        assert not torch.equal(seg, tb.tile_start)


def test_group_stop_per_batch_of_own_pairs(dense):
    # each tile stops before the first batch of BATCH of its own pairs at
    # whose start no pixel has trans > term_eps
    _, tb = dense
    eps = 1e-4
    kw = dict(width=W, height=H, sub_w=TW, sub_h=TH, bs=BS, **KW)
    stats = {}
    t_sp.blend_packed_plain(tb, term_eps=eps, stats=stats, **kw)
    T = NTX * (H // TH)
    order, seg = t_sp.partition_group_stream_plain(tb.payload[4],
                                                   tb.tile_start, T, BS)
    px, py = t_sp._tile_pixels(TW, TH, "cpu")
    # compact means are tile-relative: every tile shares the pixel grid
    f = t_sp.decode_pairs(tb.payload[:, order[:int(seg[T])].long()])
    alpha_all, _ = t_sp.alphas(t_sp.response(f, px, py), f["op"],
                               use_exp_lut=False, **KW)
    want = 0
    for t in range(T):
        lo, hi = int(seg[t]), int(seg[t + 1])
        alpha = alpha_all[:, lo:hi]
        # trans at each batch's start, from its first pair
        starts = torch.arange(0, hi - lo, t_sp.BATCH)
        trans = torch.cat([torch.ones_like(alpha[:, :1]),
                           torch.cumprod(1.0 - alpha, dim=1)], 1)[:, starts]
        dead = ~(trans > eps).any(dim=0)
        want += int(starts[dead][0]) if bool(dead.any()) else hi - lo
    assert stats["pairs_blended"] == want < int(tb.total_pairs)
    assert 0 < stats["culled_steps"] < stats["warp_steps"]


_CULL_BINNINGS: dict = {}


def _port_binning(scene, tile, compact):
    """The port's tile-sorted stream of the sparse or dense scene, built on
    the CPU."""
    key = (scene, tile, compact)
    if key not in _CULL_BINNINGS:
        n, seed, scales = {"sparse": (3000, 0, (0.02, 0.25)),
                           "dense": (1500, 4, (0.15, 0.45))}[scene]
        cfg = RenderConfig(width=W, height=H, tile_w=tile[0],
                           tile_h=tile[1])
        cloud, cam = t_random_cloud(n, seed=seed, width=W, height=H,
                                    scale_range=scales, device="cpu")
        d, m2, q, inf, col = t_rt._project_sh(cloud, cam, cfg)
        rx, ry = t_rt.screen_extents_abc(q[:, 0], q[:, 1], q[:, 2],
                                         "standard", 5.6,
                                         opacity=cloud.opacity)
        alive = t_rt.alive_mask(d, cloud.opacity, inf, cfg)
        b = t_tb.build_tile_binning(
            d, m2[:, 0], m2[:, 1], q[:, 0], q[:, 1], q[:, 2], cloud.opacity,
            col[:, 0], col[:, 1], col[:, 2], rx, ry, alive, width=W,
            height=H, tile_w=tile[0], tile_h=tile[1], max_pairs=1 << 17,
            compact=compact, stream="tile", expand_impl="xla")
        assert not bool(b.overflow)
        _CULL_BINNINGS[key] = b
    return _CULL_BINNINGS[key]


RULES = {"skip_range": dict(skip_range_check=True, use_exp_lut=False),
         "range": dict(skip_range_check=False, use_exp_lut=False),
         "range_lut": dict(skip_range_check=False, use_exp_lut=True),
         "skip_range_lut": dict(skip_range_check=True, use_exp_lut=True)}


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "f32"])
@pytest.mark.parametrize("tile", [(32, 16), (16, 16)], ids=["32x16",
                                                            "16x16"])
@pytest.mark.parametrize("scene", ["sparse", "dense"])
def test_row_cull_is_exact(scene, tile, compact):
    """Under every accept rule: no (warp rows, pair) the cull skips has a
    pixel that takes the pair."""
    b = _port_binning(scene, tile, compact)
    tw, th = tile
    ntx = t_tb.tile_extent(W, H, tw, th)[0]
    kws = {rule: dict(g_cutoff=5.6, alpha_threshold=1.0 / 255.0,
                      alpha_clamp=0.99, **r) for rule, r in RULES.items()}
    decode = t_sp.decode_pairs if compact else t_sp.decode_f32_pairs
    lx, ly = t_sp._tile_pixels(tw, th, "cpu")
    rows = t_sp.warp_rows(tw, th, "cpu")
    n = int(b.tile_start[-1])
    tiles = torch.repeat_interleave(torch.arange(ntx * (H // th)),
                                    torch.diff(b.tile_start.long()))
    culled = dict.fromkeys(RULES, 0)
    for lo in range(0, n, 4096):        # every pair, with its tile's pixels
        hi = min(lo + 4096, n)
        f = decode(b.payload[:, lo:hi])
        ty, tx = tiles[lo:hi] // ntx, tiles[lo:hi] % ntx
        px, py, oy = (lx, ly, 0.0) if compact else (
            lx[:, None] + (tx * tw).float(), ly[:, None] + (ty * th).float(),
            (ty * th).float())
        g = t_sp.response(f, px, py)
        for rule, kw in kws.items():
            _, accept = t_sp.alphas(g, f["op"], **kw)
            cull = t_sp.row_cull(f, rows, t_sp.skip_bound(f["op"], **kw), oy)
            reached = accept.reshape(-1, 32, accept.shape[1]).any(dim=1)
            bad = (cull & reached).nonzero()
            assert bad.numel() == 0, (f"{rule}: the cull skips pairs a "
                                      f"pixel takes: (warp, column) {bad[:4]}")
            culled[rule] += int(cull.sum())
    for rule, c in culled.items():      # it engages, not everywhere
        assert 0 < c < n * rows[0].numel(), rule
