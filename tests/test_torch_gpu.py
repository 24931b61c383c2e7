"""gsrt_torch CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one. The file
imports neither jax nor gsrt, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: the expand kernels and the group stream's partition are
compared bit for bit in every mode; the packed blend kernels at atol 2e-3 on
color and trans, on the tile stream with `consumed` equal, and `hits` equal
on the f32 payload (on the compact payload, both streams, at most 0.1% of
pixels off by one: the exp differs in its last bits between the kernel and
PyTorch, and a few products land on the other side of alpha_threshold); the
subtile blend kernel at 1e-4 (f32 summation order and the exp implementation
differ from the plain version's); the backward kernel per
gradient row, divided by the row's largest magnitude, at 1e-3 (the same, plus
the order of the warp and block reductions), and bit for bit against itself
on a second run; gradients of the autograd function on the card
against the plain versions on the CPU, normalised, at 1e-3; the triangle
kernels bit for bit (the binned cast's t and ids; the traversal's t, slots,
hits and executed visits in both modes: both round Möller–Trumbore as
written; the per-ray tree's t bits, slots and hits against brute force,
but for rays within 1e-5 of parallel to a small triangle, and against the
walk in tensor code, with its counters); the projection kernel bit
for bit on all twelve columns (it rounds each op as PyTorch's CUDA ops
do, see csrc/project.cu); the path tracer's shading kernel bit for bit
on every output, and a 16-bounce frame with it bit-equal to the frame
shaded by its plain version on the card (see csrc/pt_shade.cu).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt_torch import RenderConfig, _kernels
from gsrt_torch.interop import (opt_state_from_numpy, opt_state_to_numpy,
                                params_from_numpy, params_to_numpy,
                                stats_from_numpy, stats_to_numpy)
from gsrt_torch.models import densify as t_dn
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.models import tiled_diff as t_td
from gsrt_torch.models import trainer as t_tr
from gsrt_torch.ops import pair_expand as t_pe
from gsrt_torch.ops import project as t_proj
from gsrt_torch.ops import splat_grad as t_grad
from gsrt_torch.ops import splat_packed as t_sp
from gsrt_torch.ops import splat_pallas as t_pallas
from gsrt_torch.ops import splat_subtile as t_sub
from gsrt_torch.ops import tile_binning as t_tb
from gsrt_torch.scene import random_cloud
from test_torch_project import SH_CASES, edge_cloud, edge_config
from test_torch_pt_shade import (OUTPUTS, WAVE_KINDS, clone_wave, make_wave,
                                 materials, shade)

pytestmark = pytest.mark.gpu
DEAD = t_pe._DEAD_BASE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _runs_to_base(runs):
    return np.where(runs > 0, np.cumsum(runs) - runs, DEAD).astype(np.int32)


def expand_edge_cases() -> dict:
    """name -> (run lengths [n], max_pairs): the shapes a block-windowed
    expand can get wrong (its blocks hold 1024 columns)."""
    rng = np.random.default_rng(9)
    runs = lambda n: rng.integers(1, 9, n)                     # noqa: E731
    cases = {
        "long_run": (np.array([5, 3000, 7, 1]), None),   # a run > a block
        "window_full": (np.ones(2100, np.int64), None),  # 1025 sources
        "dead_tail": (np.r_[runs(300), np.zeros(200, np.int64)], 1),
        "dead_columns": (runs(500), 333),                # total < mp
        "one_source": (np.array([2500]), 501),           # n = 1
        "ragged": (runs(700), -3),                       # mp % 4 != 0
        "all_dead": (np.zeros(64, np.int64), None),
    }
    return {k: (r, int(r.sum()) + (d or 0) if r.sum() else 1500)
            for k, (r, d) in cases.items()}


def _edge_tables(case, rows, device):
    runs, mp = expand_edge_cases()[case]
    rng = np.random.default_rng(rows)
    n = runs.shape[0]
    tab = rng.integers(-2**31, 2**31 - 1, (rows, n)).astype(np.int32)
    tab[0] = (rng.integers(0, 60, n) | (rng.integers(0, 60, n) << 12)
              | (rng.integers(0, 8, n) << 24))
    tab[1] = _runs_to_base(runs)
    tab[2:4] = rng.normal(300, 900, (2, n)).astype(np.float32).view(
        np.int32)
    tab = torch.as_tensor(tab, device=device)
    return tab, tab[1].contiguous(), mp, int(runs.sum())


@pytest.mark.parametrize("case", list(expand_edge_cases()))
def test_expand_kernels_edge_cases_bitwise(cuda, case):
    """The copy kernel at the triangle binning's 15 rows and the emit
    kernel on each edge case, bit for bit against the plain versions, and
    a second launch equal to the first."""
    tab, base, mp, total = _edge_tables(case, 15, cuda)
    got = t_pe.expand_pairs_fused(tab, base, mp)
    assert torch.equal(got, t_pe.expand_pairs_plain(tab, base, mp))
    assert torch.equal(t_pe.expand_pairs_fused(tab, base, mp), got)
    kw = dict(total=torch.tensor(max(min(total, mp) - 5, 0),
                                 dtype=torch.int32, device=cuda),
              ntx=60, T=60 * 70, tile_w=32, tile_h=16)
    emit = tab[:t_pe.EMIT_TAB_ROWS].contiguous()
    got = t_pe.expand_pairs_binned(emit, base, mp, **kw)
    assert torch.equal(got, t_pe.expand_pairs_binned_plain(emit, base, mp,
                                                           **kw))
    assert torch.equal(t_pe.expand_pairs_binned(emit, base, mp, **kw), got)


def test_expand_copy_kernel_bitwise(cuda):
    rng = np.random.default_rng(2)
    n = 50_000
    runs = np.where(np.arange(n) < 45_000, rng.integers(1, 9, n), 0)
    base = torch.as_tensor(_runs_to_base(runs), device=cuda)
    tab = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (8, n))
                          .astype(np.int32), device=cuda)
    before = _kernels.EXPAND_PLAIN.launches
    for mp in (int(runs.sum()) + 1000, int(runs.sum()) - 777):
        assert torch.equal(t_pe.expand_pairs_fused(tab, base, mp),
                           t_pe.expand_pairs_plain(tab, base, mp))
    assert _kernels.EXPAND_PLAIN.launches == before + 2


def test_expand_gather_kernel_bitwise(cuda):
    rng = np.random.default_rng(4)
    n = 50_000
    runs = np.where(np.arange(n) < 45_000, rng.integers(1, 9, n), 0)
    base = torch.as_tensor(_runs_to_base(runs), device=cuda)
    tab = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (11, n))
                          .astype(np.int32), device=cuda)
    before = _kernels.EXPAND_PAIRS.launches
    for mp in (int(runs.sum()) + 1000, int(runs.sum()) - 777):
        got = t_pe.expand_pairs(tab, base, mp)
        assert torch.equal(got, t_pe.expand_pairs_plain(tab, base, mp))
        assert torch.equal(got, t_pe.expand_pairs_fused(tab, base, mp))
    assert _kernels.EXPAND_PAIRS.launches == before + 2


def _expand_pairs_case(case, rng):
    """(run lengths, max_pairs) of the cases expand_pairs must get right."""
    if case == "f32_table":     # the training cell's table: 100K sources
        return rng.integers(1, 41, 100_000), 1 << 21
    if case == "ragged":        # max_pairs % 4 != 0: strided stores
        runs = rng.integers(1, 41, 100_000)
        return runs, int(runs.sum()) - 3
    if case == "no_live_source":
        return np.zeros(5_000, np.int64), 4_099
    # just past 2^24 pairs, where the TPU kernel needs its fallback
    runs = rng.integers(1, 33, 1_100_000)
    return runs, (1 << 24) + (4096 if case == "over_2e24" else 5)


@pytest.mark.parametrize("case", ["f32_table", "ragged", "no_live_source",
                                  "over_2e24", "over_2e24_ragged"])
def test_expand_pairs_one_launch_bitwise(cuda, case, monkeypatch):
    """expand_pairs at the f32 table's 11 rows is one launch of the copy
    kernel, with no torch.searchsorted, and equals its plain version bit
    for bit."""
    rng = np.random.default_rng(11)
    runs, mp = _expand_pairs_case(case, rng)
    assert case != "over_2e24" or runs.sum() > mp > 1 << 24
    n = runs.shape[0]
    base = torch.as_tensor(_runs_to_base(runs), device=cuda)
    tab = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (11, n))
                          .astype(np.int32), device=cuda)
    before = _kernels.launch_counts()

    def no_search(*a, **kw):
        raise AssertionError("expand_pairs searched outside its kernel")
    with monkeypatch.context() as m:
        m.setattr(torch, "searchsorted", no_search)
        got = t_pe.expand_pairs(tab, base, mp)
    after = _kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"expand_pairs": 1}
    assert torch.equal(got, t_pe.expand_pairs_plain(tab, base, mp))


def test_expand_emit_kernel_bitwise(cuda):
    rng = np.random.default_rng(3)
    n, ntx, nty, tw, th = 20_000, 60, 68, 32, 16
    x0 = rng.integers(0, ntx, n)
    w = np.minimum(rng.integers(1, 4, n), ntx - x0)
    ys = rng.integers(0, nty, n)
    rows = np.minimum(rng.integers(1, 3, n), nty - ys)
    runs = np.where(np.arange(n) < 19_000, rows * w, 0)
    mx = ((x0 + w / 2) * tw + rng.normal(0, 40, n)).astype(np.float32)
    my = ((ys + rows / 2) * th + rng.normal(0, 40, n)).astype(np.float32)
    mx[:3] = [3000.0, -2500.0, 70.0]
    words = rng.integers(-2**31, 2**31 - 1, (3, n)).astype(np.int32)
    tab = np.stack([(x0 | (ys << 12) | (w << 24)).astype(np.int32),
                    _runs_to_base(runs), mx.view(np.int32),
                    my.view(np.int32), *words])
    tab_t = torch.as_tensor(tab, device=cuda)
    total = int(runs.sum())
    kw = dict(total=torch.tensor(total - 5, dtype=torch.int32, device=cuda),
              ntx=ntx, T=ntx * nty, tile_w=tw, tile_h=th)
    before = _kernels.EXPAND_EMIT.launches
    got = t_pe.expand_pairs_binned(tab_t, tab_t[1].contiguous(), total + 99,
                                   **kw)
    want = t_pe.expand_pairs_binned_plain(tab_t, tab_t[1].contiguous(),
                                          total + 99, **kw)
    assert torch.equal(got, want)
    assert _kernels.EXPAND_EMIT.launches == before + 1


def _group_binning(cuda, tile=(32, 16), W=320, H=256):
    """The group-contiguous compact stream of a 20K-splat view."""
    cfg = RenderConfig(width=W, height=H, tile_w=tile[0], tile_h=tile[1])
    cloud, cam = random_cloud(20_000, seed=1, width=W, height=H,
                              device=cuda)
    tr = t_rt.GaussianRayTracer(cfg, "tiled", device=cuda)
    tr.calibrate(cloud, cam)
    d, m2, q, inf, col = t_rt._project_sh(cloud, cam, cfg)
    rx, ry = t_rt.screen_extents_abc(q[:, 0], q[:, 1], q[:, 2], "standard",
                                     5.6, opacity=cloud.opacity)
    alive = inf & (cloud.opacity > 1 / 255) & (d > 1e-3) & (d < 1e4)
    b = t_tb.build_tile_binning(
        d, m2[:, 0], m2[:, 1], q[:, 0], q[:, 1], q[:, 2], cloud.opacity,
        col[:, 0], col[:, 1], col[:, 2], rx, ry, alive, width=W, height=H,
        tile_w=tile[0], tile_h=tile[1], max_pairs=tr.max_pairs,
        max_rows=tr.max_rows)
    assert not bool(b.overflow)
    ntx = t_tb.tile_extent(W, H, *tile)[0]
    kw = dict(width=W, height=H, sub_w=tile[0], sub_h=tile[1],
              bs=t_tb.group_rows_k(ntx) * ntx)
    return b, kw


def _clamped(b, keep=0.7):
    """The stream the binning hands over when max_pairs cuts it."""
    cap = int(int(b.total_pairs) * keep)
    return b._replace(payload=b.payload[:, :cap].contiguous(),
                      tile_start=torch.clamp_max(b.tile_start, cap))


def _hits_close(hk, hp):
    """The compact payload's hit rule: at most 1 apart, on at most 0.1% of
    pixels."""
    diff = (hk - hp).abs()
    return diff.max().item() <= 1 and (diff != 0).float().mean().item() \
        <= 1e-3


@pytest.mark.parametrize("clamp", [False, True])
def test_partition_kernel_bitwise(cuda, clamp):
    b, kw = _group_binning(cuda)
    if clamp:
        b = _clamped(b)
    T = t_tb.tile_extent(kw["width"], kw["height"], kw["sub_w"],
                         kw["sub_h"])
    T = T[0] * T[1]
    before = _kernels.PARTITION.launches
    ok, sk = t_sp.partition_group_stream(b, T, kw["bs"])
    op, sp = t_sp.partition_group_stream_plain(b.payload[4], b.tile_start,
                                               T, kw["bs"])
    assert _kernels.PARTITION.launches == before + 1
    n = int(sp[T])
    assert torch.equal(sk, sp)
    assert torch.equal(ok[:n], op[:n])
    assert torch.equal(sk, b.tile_start) != clamp


def test_blend_kernel_matches_plain(cuda):
    b, kw = _group_binning(cuda)
    kw["skip_range_check"] = True
    before = _kernels.BLEND_GROUP.launches, _kernels.PARTITION.launches
    ck, tk, hk = t_sp.blend_packed(b, track_hits=True, **kw)
    cp, tp, hp = t_sp.blend_packed_plain(b, track_hits=True, **kw)
    assert (_kernels.BLEND_GROUP.launches, _kernels.PARTITION.launches) \
        == (before[0] + 1, before[1] + 1)
    assert (ck - cp).abs().max().item() <= 2e-3
    assert (tk - tp).abs().max().item() <= 2e-3
    assert _hits_close(hk, hp)


@pytest.mark.parametrize("mode", ["lut", "range", "tiles16", "overflow"])
def test_group_blend_kernel_modes(cuda, mode):
    b, kw = _group_binning(cuda, (16, 16) if mode == "tiles16" else
                           (32, 16))
    kw["skip_range_check"] = mode not in ("lut", "range")
    kw["use_exp_lut"] = mode == "lut"
    if mode == "overflow":
        b = _clamped(b)
    ck, tk, hk = t_sp.blend_packed(b, track_hits=True, **kw)
    cp, tp, hp = t_sp.blend_packed_plain(b, track_hits=True, **kw)
    assert (ck - cp).abs().max().item() <= 2e-3
    assert (tk - tp).abs().max().item() <= 2e-3
    assert _hits_close(hk, hp)
    c2, t2 = t_sp.blend_packed(b, **kw)        # hits change no pixel
    assert torch.equal(c2, ck) and torch.equal(t2, tk)


def test_render_tiled_cuda_matches_cpu(cuda):
    cfg = RenderConfig(width=256, height=256)
    c, cam = random_cloud(3000, seed=0, width=256, height=256, device="cpu")
    out_cpu = t_rt.render_tiled(c, cam, cfg, max_pairs=1 << 16,
                                max_rows=1 << 14)
    out_gpu = t_rt.render_tiled(c.to(cuda), cam.to(cuda), cfg,
                                max_pairs=1 << 16, max_rows=1 << 14)
    assert not bool(out_gpu.overflow)
    np.testing.assert_allclose(out_gpu.color.cpu().numpy(),
                               out_cpu.color.numpy(), atol=2e-3)
    np.testing.assert_allclose(out_gpu.trans.cpu().numpy(),
                               out_cpu.trans.numpy(), atol=2e-3)


@pytest.mark.parametrize("use_exp_lut", [False, True])
@pytest.mark.parametrize("chunk", [128, 384])
@pytest.mark.parametrize("compact", [True, False])
def test_tile_blend_kernel_matches_plain(cuda, compact, chunk, use_exp_lut):
    W, H = 320, 256
    cfg = RenderConfig(width=W, height=H, tile_w=16, tile_h=16)
    cloud, cam = random_cloud(20_000, seed=1, width=W, height=H,
                              device=cuda)
    d, m2, q, inf, col = t_rt._project_sh(cloud, cam, cfg)
    rx, ry = t_rt.screen_extents_abc(q[:, 0], q[:, 1], q[:, 2], "standard",
                                     5.6, opacity=cloud.opacity)
    alive = t_rt.alive_mask(d, cloud.opacity, inf, cfg)
    b = t_tb.build_tile_binning(
        d, m2[:, 0], m2[:, 1], q[:, 0], q[:, 1], q[:, 2], cloud.opacity,
        col[:, 0], col[:, 1], col[:, 2], rx, ry, alive, width=W, height=H,
        tile_w=16, tile_h=16, max_pairs=1 << 19, compact=compact,
        stream="tile", carry_depth=True)
    assert not bool(b.overflow)
    kw = dict(width=W, height=H, sub_w=16, sub_h=16, bs=128, chunk=chunk,
              skip_range_check=not use_exp_lut, use_exp_lut=use_exp_lut)
    before = _kernels.BLEND_TILE.launches
    ck, tk, consk, hk = t_sp.blend_packed(
        b, track_consumed=True, track_hits=True, group_stream=False, **kw)
    cp, tp, consp, hp = t_sp.blend_packed_tile_plain(b, **kw)
    assert _kernels.BLEND_TILE.launches == before + 1
    assert (ck - cp).abs().max().item() <= 2e-3
    assert (tk - tp).abs().max().item() <= 2e-3
    assert torch.equal(consk, consp)
    assert (consp[0] < consp[0].max()).any()          # some tiles saturate
    diff = (hk - hp).abs()
    if compact:
        assert diff.max().item() <= 1
        assert (diff != 0).float().mean().item() <= 1e-3
    else:
        assert torch.equal(hk, hp)
    # the modes alone give the same image
    c2, t2 = t_sp.blend_packed(b, group_stream=False, **kw)
    assert torch.equal(c2, ck) and torch.equal(t2, tk)


def test_blend_tiles_kernel_matches_plain(cuda):
    b, kw = _f32_binning(cuda, (128, 8), False)
    before = _kernels.BLEND_TILES.launches
    for lut in (False, True):
        ck, tk = t_pallas.blend_tiles(b, use_exp_lut=lut,
                                      skip_range_check=not lut, **kw)
        cp, tp = t_sub.blend_subtiles_plain(
            b, sub_w=128, sub_h=8, use_exp_lut=lut, skip_range_check=not lut,
            **kw)
        assert (ck - cp).abs().max().item() <= 1e-4
        assert (tk - tp).abs().max().item() <= 1e-4
    assert _kernels.BLEND_TILES.launches == before + 2


def _f32_binning(cuda, tile, wall: bool):
    """A 160x96 view of 3000 splats binned on the f32 tile stream; with
    `wall`, three image-covering splats at a clamped alpha sit 30 splats
    deep, so every tile stops at a chunk boundary."""
    W, H = 160, 96
    cfg = RenderConfig(width=W, height=H, tile_w=tile[0], tile_h=tile[1])
    cloud, cam = random_cloud(3000, seed=2, width=W, height=H, device=cuda)
    d, m2, q, inf, col = t_rt._project_sh(cloud, cam, cfg)
    rx, ry = t_rt.screen_extents_abc(q[:, 0], q[:, 1], q[:, 2], "standard",
                                     5.6, opacity=cloud.opacity)
    alive = t_rt.alive_mask(d, cloud.opacity, inf, cfg)
    qa, qb, qc, op = q[:, 0].clone(), q[:, 1].clone(), q[:, 2].clone(), \
        cloud.opacity.clone()
    if wall:
        idx = torch.argsort(torch.where(alive, d, torch.inf))[30:33]
        qa[idx], qb[idx], qc[idx], op[idx] = 1e-6, 0.0, 1e-6, 0.999
        rx, ry = rx.clone(), ry.clone()
        rx[idx] = ry[idx] = 1e4
    b = t_tb.build_tile_binning(
        d, m2[:, 0], m2[:, 1], qa, qb, qc, op, col[:, 0], col[:, 1],
        col[:, 2], rx, ry, alive, width=W, height=H, tile_w=tile[0],
        tile_h=tile[1], max_pairs=1 << 17, compact=False, with_ids=True)
    assert not bool(b.overflow)
    return b, dict(width=W, height=H, chunk=128, g_cutoff=5.6,
                   alpha_threshold=1 / 255, alpha_clamp=0.99)


@pytest.mark.parametrize("skip_range_check", [True, False])
@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (128, 8)])
def test_subtile_kernels_match_plain(cuda, tile, wall, skip_range_check):
    _subtile_kernels_match_plain(cuda, tile, wall, skip_range_check, False)


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (128, 8)])
def test_subtile_kernels_lut_match_plain(cuda, tile):
    _subtile_kernels_match_plain(cuda, tile, True, False, True)


def _subtile_kernels_match_plain(cuda, tile, wall, skip_range_check,
                                 use_exp_lut):
    b, kw = _f32_binning(cuda, tile, wall)
    kw.update(skip_range_check=skip_range_check, use_exp_lut=use_exp_lut)
    fwd = _kernels.BLEND_SUBTILE.launches
    ck, tk = t_sub.blend_subtiles(b, sub_w=tile[0], sub_h=tile[1], **kw)
    stats = {}
    cp, tp = t_sub.blend_subtiles_plain(b, sub_w=tile[0], sub_h=tile[1],
                                        stats=stats, **kw)
    assert _kernels.BLEND_SUBTILE.launches == fwd + 1
    assert (stats["pairs_blended"] < int(b.total_pairs)) == wall
    assert (ck - cp).abs().max().item() <= 1e-4
    assert (tk - tp).abs().max().item() <= 1e-4

    g = torch.Generator(device=cuda).manual_seed(1)
    planes = [cp[..., 0], cp[..., 1], cp[..., 2], tp] + [
        torch.randn(tp.shape, generator=g, device=cuda) for _ in range(4)]
    pix = torch.stack([t_td.tilefy(p, *tile) for p in planes])
    bwd = _kernels.BLEND_BACKWARD.launches
    args = (b.payload, b.tile_start, pix)
    gk = t_grad.blend_backward(*args, tile_w=tile[0], tile_h=tile[1], **kw)
    gp = t_grad.blend_backward_plain(*args, tile_w=tile[0], tile_h=tile[1],
                                     **kw)
    assert _kernels.BLEND_BACKWARD.launches == bwd + 1
    for r in range(t_grad.GRAD_ROWS):
        scale = gp[r].abs().max().item()
        assert scale > 0
        assert ((gk[r] - gp[r]).abs().max().item() / scale) <= 1e-3, r


# pairs of the four tiles of edge_stream: more than 256 with a wall that
# saturates mid-chunk, none, a partial batch, one pair into a second chunk
EDGE_COUNTS, EDGE_WALL, EDGE_EPS = (300, 0, 100, 129), 40, 0.5


def edge_stream(tile, device):
    """A hand-made f32 tile stream over 2x2 tiles: splats 1.5-6 px across
    inside their tile; in tile 0 pair EDGE_WALL covers the tile at alpha
    0.7, so with term_eps = EDGE_EPS every pixel is saturated from there
    on, the walk stops at pair 128 and not at the end of its 32-pair batch
    (pairs 64-127 still count); tile 3's faint splats keep it unsaturated
    into its second chunk. (payload [8, L], tile_start, W, H)."""
    tw, th = tile
    rng = np.random.default_rng(sum(tile))
    cols, starts = [], [0]
    for t, n in enumerate(EDGE_COUNTS):
        ox, oy = (t % 2) * tw, (t // 2) * th
        s = rng.uniform(1.5, 6.0, (2, n))
        rho = rng.uniform(-0.6, 0.6, n)
        det = (s[0] * s[1]) ** 2 * (1 - rho ** 2)
        c = np.stack([rng.uniform(ox - 2, ox + tw + 2, n),
                      rng.uniform(oy - 2, oy + th + 2, n),
                      s[1] ** 2 / det, -rho * s[0] * s[1] / det,
                      s[0] ** 2 / det, rng.uniform(0.0, 1.3, n),
                      rng.uniform(0.0, 1.3, n), rng.uniform(0.0, 1.3, n),
                      rng.uniform(0.02, 0.05, n) if t == 3
                      else rng.uniform(0.2, 0.9, n)])
        if t == 0:
            c[:, EDGE_WALL] = [ox + tw / 2, oy + th / 2, 1e-6, 0.0, 1e-6,
                               0.5, 0.5, 0.5, 0.7]
        cols.append(c)
        starts.append(starts[-1] + n)
    c = torch.as_tensor(np.concatenate(cols, 1), dtype=torch.float32)
    pay = torch.zeros((8, starts[-1] + 40), dtype=torch.int32)
    pay[:5, :starts[-1]] = c[:5].view(torch.int32)
    pay[5, :starts[-1]] = t_tb.pack15(c[5], c[6])
    pay[6, :starts[-1]] = t_tb.pack15(c[7], c[8])
    ts = torch.tensor(starts, dtype=torch.int32)
    return pay.to(device), ts.to(device), 2 * tw, 2 * th


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (128, 8), (32, 3)])
def test_subtile_kernels_stop_and_edges(cuda, tile):
    """Forward, blend_tiles and backward on edge_stream under both rules
    and the LUT: against the plain versions, the stop at pair 128 of the
    saturated tile, and the backward bit-equal on two runs. At 32x3 a
    thread's last rows fall past the tile in both kernels."""
    tw, th = tile
    pay, ts, W, H = edge_stream(tile, cuda)
    b = t_tb.TileBinning(payload=pay, tile_start=ts,
                         tile_count=torch.diff(ts),
                         total_pairs=ts[-1].clone(),
                         overflow=torch.zeros((), dtype=torch.bool,
                                              device=cuda))
    base = dict(width=W, height=H, chunk=128, g_cutoff=5.6,
                alpha_threshold=1 / 255, alpha_clamp=0.99,
                term_eps=EDGE_EPS)
    g = torch.Generator(device=cuda).manual_seed(3)
    for skip, lut in ((True, False), (False, False), (False, True)):
        kw = dict(base, skip_range_check=skip, use_exp_lut=lut)
        ck, tk = t_sub.blend_subtiles(b, sub_w=tw, sub_h=th, **kw)
        stats = {}
        cp, tp = t_sub.blend_subtiles_plain(b, sub_w=tw, sub_h=th,
                                            stats=stats, **kw)
        assert stats["pairs_blended"] == 128 + 100 + 129
        assert (ck - cp).abs().max().item() <= 1e-4
        assert (tk - tp).abs().max().item() <= 1e-4
        assert (tp[:th, :tw] <= EDGE_EPS).all()
        assert (tp[:th, tw:] == 1).all()                  # the empty tile
        if tile == (128, 8):
            c2, t2 = t_pallas.blend_tiles(b, **kw)
            assert torch.equal(c2, ck) and torch.equal(t2, tk)
        planes = [cp[..., 0], cp[..., 1], cp[..., 2], tp] + [
            torch.randn(tp.shape, generator=g, device=cuda)
            for _ in range(4)]
        pix = torch.stack([t_td.tilefy(p, tw, th) for p in planes])
        args = (pay, ts, pix)
        gk = t_grad.blend_backward(*args, tile_w=tw, tile_h=th, **kw)
        gp = t_grad.blend_backward_plain(*args, tile_w=tw, tile_h=th, **kw)
        assert torch.equal(gk, t_grad.blend_backward(
            *args, tile_w=tw, tile_h=th, **kw))
        for r in range(t_grad.GRAD_ROWS):
            scale = gp[r].abs().max().item()
            assert scale > 0
            assert ((gk[r] - gp[r]).abs().max().item() / scale) <= 1e-3, r
        # the saturated tile: pairs 64-127 count, 128 on get nothing
        assert (gk[6:, 64:128].abs().sum(0) > 0).any()
        assert not (gk[:, 128:300] != 0).any()
        assert not (gk[:, int(ts[-1]):] != 0).any()


def test_tiled_diff_gradients_cuda_match_cpu(cuda):
    W, H = 160, 96
    cfg = RenderConfig(width=W, height=H)
    c, cam = random_cloud(2000, seed=3, width=W, height=H, device="cpu")
    wc = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(0))

    def grads(dev):
        leaf = type(c)(*(t.to(dev).clone().requires_grad_() for t in c))
        color, trans = t_td.render_tiled_diff(leaf, cam.to(dev), cfg,
                                              1 << 17)
        ((color * wc.to(dev)).sum() + trans.sum()).backward()
        return [t.grad.cpu() for t in leaf]

    before = _kernels.launch_counts()
    got, want = grads(cuda), grads("cpu")
    after = _kernels.launch_counts()
    for k in ("expand_pairs_fused", "blend_subtiles", "blend_backward"):
        assert after[k] == before[k] + 1, k
    for g, w, name in zip(got, want, c._fields):
        assert torch.isfinite(g).all(), name
        scale = w.abs().max().item()
        assert ((g - w).abs().max().item() / scale) <= 1e-3, name


def test_traced_train_step_splits_the_backward(cuda, tmp_path):
    """A CUDA `train_step_tiled` under a recording profiler: its four
    backward stages open on autograd's device thread (their ranges on
    another thread than the step's) as children of `train.backward`, in
    order, each with device ms > 0 and together at most the backward's;
    the loss and the parameters bit-equal to an untraced step's."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from gsrt_torch.utils.profiling import TRACER
    W, H = 160, 96
    cfg = RenderConfig(width=W, height=H)
    cloud, cam = random_cloud(2000, seed=3, width=W, height=H, device=cuda)
    target = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(0)
                        ).to(cuda)
    stages = ["train.loss_bwd", "train.blend_bwd", "train.project_bwd",
              "train.activate_bwd"]

    def step():
        params = t_tr.init_params(cloud)
        opt = t_tr.make_optimizer(params)
        loss = t_tr.train_step_tiled(params, opt, target, cam, cfg, 1 << 17)
        return [loss] + [p.detach().clone() for p in params.parameters()]

    off = step()
    TRACER.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            on = step()
        rep = TRACER.report()
    finally:
        TRACER.reset()
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    back = [i for i, s in enumerate(rep) if s["name"] == "train.backward"]
    assert len(back) == 1
    kids = [s for s in rep if s["parent"] == back[0]]
    assert [s["name"] for s in kids] == stages
    assert all(s["device_ms"] > 0 for s in kids)
    assert sum(s["device_ms"] for s in kids) <= rep[back[0]]["device_ms"]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tids = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation":
            tids.setdefault(e["name"], set()).add(e.get("tid"))
    step_tid = tids["train.step"]
    for name in stages:
        assert tids[name].isdisjoint(step_tid), name


def _tri_soup(n, seed, spread=2.0, size=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    a = c + rng.normal(0, size, (n, 3)).astype(np.float32)
    b = c + rng.normal(0, size, (n, 3)).astype(np.float32)
    return c, a, b


@pytest.mark.parametrize("span_exact", [False, True])
@pytest.mark.parametrize("tile", [(16, 8), (32, 16)])
def test_tri_cast_kernel_bitwise(cuda, tile, span_exact):
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.models import path_tracer as t_pt
    from gsrt_torch.ops import tri_binning as t_tbin
    W, H = 200, 120
    cam = make_camera(look_at((0, 0, -7.0), (0, 0, 0)), 55.0, W, H,
                      device=cuda)
    v0, v1, v2 = (torch.as_tensor(a, device=cuda)
                  for a in _tri_soup(2000, 5))
    b = t_tbin.build_tri_binning(v0, v1, v2, cam, tile_w=tile[0],
                                 tile_h=tile[1], max_pairs=1 << 19,
                                 span_exact=span_exact)
    assert not bool(b.overflow)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, dirs = t_pt.generate_camera_rays(gen, cam, RenderConfig(width=W,
                                                               height=H))
    before = _kernels.TRI_CAST.launches
    kw = dict(width=W, height=H, tile_w=tile[0], tile_h=tile[1])
    t_k, id_k = t_tbin.cast_primary(b, dirs, cam.position, **kw)
    stats = {}
    t_p, id_p = t_tbin.cast_primary_plain(b, dirs, cam.position,
                                          stats=stats, **kw)
    assert _kernels.TRI_CAST.launches == before + 1
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
    assert (t_k < 3e38).float().mean() > 0.2
    # the image has a row or column of edge tiles; the warp cull removes
    # steps; a second launch gives the same bits
    assert W % tile[0] or H % tile[1]
    assert 0 < stats["culled_steps"] < stats["warp_steps"]
    t_2, id_2 = t_tbin.cast_primary(b, dirs, cam.position, **kw)
    assert torch.equal(t_2, t_k) and torch.equal(id_2, id_k)


@pytest.mark.parametrize("span_exact", [False, True])
def test_tri_cast_kernel_overflowed_binning(cuda, span_exact):
    """A binning cut short by max_pairs has tile segments whose zmin does
    not ascend; the kernel, which does not rely on the order, still
    equals the plain version bit for bit."""
    from gsrt_torch.core.types import look_at, make_camera
    from gsrt_torch.models import path_tracer as t_pt
    from gsrt_torch.ops import tri_binning as t_tbin
    W, H = 200, 120
    cam = make_camera(look_at((0, 0, -7.0), (0, 0, 0)), 55.0, W, H,
                      device=cuda)
    v = [torch.as_tensor(a, device=cuda) for a in _tri_soup(2000, 6)]
    full = t_tbin.build_tri_binning(*v, cam, tile_w=16, tile_h=8,
                                    max_pairs=1 << 19, span_exact=span_exact)
    b = t_tbin.build_tri_binning(*v, cam, tile_w=16, tile_h=8,
                                 max_pairs=int(full.total_pairs) // 2,
                                 span_exact=span_exact)
    assert bool(b.overflow)
    gen = torch.Generator(device=cuda).manual_seed(1)
    _, dirs = t_pt.generate_camera_rays(gen, cam, RenderConfig(width=W,
                                                               height=H))
    kw = dict(width=W, height=H, tile_w=16, tile_h=8)
    t_k, id_k = t_tbin.cast_primary(b, dirs, cam.position, **kw)
    t_p, id_p = t_tbin.cast_primary_plain(b, dirs, cam.position, **kw)
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p)


@pytest.mark.parametrize("rb", [128, 512, 1024])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tri_traverse_kernel_matches_plain(cuda, any_hit, rb):
    from gsrt_torch.ops import tri_kernel as t_tk
    v0, v1, v2 = (torch.as_tensor(a, device=cuda)
                  for a in _tri_soup(5000, 6, spread=3.0, size=0.2))
    tt = t_tk.build_tri_table(v0, v1, v2)
    rng = np.random.default_rng(7)
    R = 3000
    o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    o[: R // 2] = np.float32([0, 0, -8]) + 0.3 * o[: R // 2]
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[: R // 2] = np.float32([0, 0, 1]) + 0.2 * d[: R // 2]
    o, d = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    tmax = torch.as_tensor(rng.uniform(1, 20, R).astype(np.float32),
                           device=cuda)
    kernel = _kernels.TRI_ANY_HIT if any_hit else _kernels.TRI_CLOSEST_HIT
    before = kernel.launches
    got = t_tk.closest_hit_packed(tt, o, d, 1e-3, tmax, rb=rb,
                                  any_hit=any_hit)
    want = t_tk.closest_hit_packed_plain(tt, o, d, 1e-3, tmax, rb=rb,
                                         any_hit=any_hit)
    assert kernel.launches == before + 1
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert torch.equal(got[3].actual, want[3].actual)
    assert got[2].float().mean() > 0.2


def _patch(x0, x1, y0, y1, z, n, tilt=0.05):
    """An n x n grid of quads (two triangles each) over [x0, x1] x [y0, y1]
    in the plane z + tilt * x (the tilt keeps entry distances apart)."""
    xs, ys = np.linspace(x0, x1, n + 1), np.linspace(y0, y1, n + 1)
    tris = []
    for iy in range(n):
        for ix in range(n):
            a, b = (xs[ix], ys[iy]), (xs[ix + 1], ys[iy + 1])
            tris += [((a[0], a[1]), (b[0], a[1]), (a[0], b[1])),
                     ((b[0], b[1]), (a[0], b[1]), (b[0], a[1]))]
    p = np.float32(tris)                                   # [T, 3, 2]
    v = np.concatenate([p, z + tilt * p[..., :1]], -1)
    return v[:, 0], v[:, 1], v[:, 2]


def _warp_rays(R, spans, seed):
    """Rays along +z from z = -5, warp w's origins at x in spans[w % 2]
    (y in [-0.8, 0.8]): neighbouring warps of a block look at other
    places."""
    rng = np.random.default_rng(seed)
    w = (np.arange(R) // 32) % 2
    lo = np.float32([spans[0][0], spans[1][0]])[w]
    hi = np.float32([spans[0][1], spans[1][1]])[w]
    o = np.stack([rng.uniform(lo, hi), rng.uniform(-0.8, 0.8, R),
                  np.full(R, -5.0)], 1).astype(np.float32)
    d = (np.float32([0, 0, 1]) + rng.normal(0, 0.01, (R, 3))).astype(
        np.float32)
    return o, d


def _traverse_both(cuda, verts, o, d, rb, any_hit):
    """Kernel and plain on one bundle: (kernel out, plain out, stats)."""
    from gsrt_torch.ops import tri_kernel as t_tk
    tt = t_tk.build_tri_table(*(torch.as_tensor(np.ascontiguousarray(a),
                                                device=cuda) for a in verts))
    o, d = torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda)
    kernel = _kernels.TRI_ANY_HIT if any_hit else _kernels.TRI_CLOSEST_HIT
    before = kernel.launches
    got = t_tk.closest_hit_packed(tt, o, d, 1e-3, 100.0, rb=rb,
                                  any_hit=any_hit)
    assert kernel.launches == before + 1
    stats = {}
    want = t_tk.closest_hit_packed_plain(tt, o, d, 1e-3, 100.0, rb=rb,
                                         any_hit=any_hit, stats=stats)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert torch.equal(got[3].actual, want[3].actual)
    return got, stats


@pytest.mark.parametrize("rb", [128, 512, 1024])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tri_traverse_warps_skip_clusters_others_hit(cuda, any_hit, rb):
    """Two patches far apart in one super-cluster; alternate warps of each
    block look at one or the other, so every block reaches all clusters
    and every warp only its own patch's."""
    verts = tuple(np.concatenate(a) for a in zip(
        _patch(-4, -2, -1, 1, 0, 16), _patch(2, 4, -1, 1, 0, 16)))
    o, d = _warp_rays(2048, ((-3.8, -2.2), (2.2, 3.8)), 0)
    got, stats = _traverse_both(cuda, verts, o, d, rb, any_hit)
    assert stats["group_clusters_tested"] * 32 < \
        stats["clusters_tested"] * rb
    assert got[2].float().mean() > 0.9


@pytest.mark.parametrize("rb", [128, 512, 1024])
def test_tri_traverse_any_hit_occluded_warps(cuda, rb):
    """Any hit: an occluder in front of x < 0 and layers behind all of it.
    The warps looking at x < 0 all hit the occluder early and then skip
    every cluster; the others walk the layers."""
    verts = tuple(np.concatenate(a) for a in zip(
        _patch(-4, 0, -1, 1, 0, 16),
        *(_patch(-4, 4, -1, 1, z, 16) for z in (2, 3, 4, 5))))
    o, d = _warp_rays(2048, ((-3.8, -0.2), (0.2, 3.8)), 1)
    got, stats = _traverse_both(cuda, verts, o, d, rb, True)
    assert stats["group_clusters_tested"] * 32 < \
        stats["clusters_tested"] * rb
    front = torch.as_tensor((np.arange(2048) // 32) % 2 == 0, device=cuda)
    assert bool(got[2][front].all())
    assert bool((got[0][front] < 6.0).all())     # the occluder's t


@pytest.fixture(scope="module")
def bvh_scenes():
    """The 5,000-triangle soup and a room of 20,000 triangles (the
    path-tracing cell's generator) with their tables and per-ray trees,
    on the card: {name: (vertices as NumPy, table)}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    from gsrt_torch.ops import tri_bvh as t_bvh
    from gsrt_torch.ops import tri_kernel as t_tk
    from test_torch_tri_bvh import room_scene, soup
    v = soup()
    tt = t_tk.build_tri_table(*(torch.as_tensor(a, device="cuda")
                                for a in v))
    s, ps = room_scene(20_000, device="cuda")
    return {"soup": (v, tt._replace(bvh=t_bvh.build_tri_bvh(tt))),
            "room": ((s.v0, s.v1, s.v2), ps.tri_table)}


@pytest.mark.parametrize("kind", ["random", "grazing", "edges", "parked",
                                  "t_min", "axis", "fixtures"])
@pytest.mark.parametrize("scene", ["soup", "room"])
def test_tri_bvh_kernel_matches_plain(cuda, bvh_scenes, scene, kind):
    """The per-ray kernel against its plain version (brute force): t bits,
    slots and hits equal (rays grazing the smallest triangles: but for
    at most 0.2% that meet a triangle within 1e-5 of parallel, see
    test_torch_tri_bvh.py); t bits, slots and counters equal the walk's
    in tensor code; one launch a call, and the same bits without
    counters."""
    from gsrt_torch.ops import tri_bvh as t_bvh
    from test_torch_tri_bvh import bvh_rays, differ_near_parallel
    verts, tt = bvh_scenes[scene]
    R = 4096
    o, d, t_min, t_max = bvh_rays(kind, verts, R=R, seed=11, device=cuda)
    counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    before = _kernels.TRI_BVH.launches
    t, slot, hit = t_bvh.closest_hit_bvh(tt, o, d, t_min, t_max,
                                         counts=counts)
    assert _kernels.TRI_BVH.launches == before + 1
    want = t_bvh.closest_hit_bvh_plain(tt, o, d, t_min, t_max)
    n_bad = differ_near_parallel(tt, d, (t, slot), want)
    assert n_bad <= (2e-3 * R if kind == "fixtures" else 0)
    if not n_bad:
        assert torch.equal(hit, want[2])
    t_w, slot_w, walked = t_bvh.walk_bvh_plain(tt, o, d, t_min, t_max)
    assert torch.equal(t.view(torch.int32), t_w.view(torch.int32))
    assert torch.equal(slot, slot_w)
    assert torch.equal(counts.cpu(), walked)
    t2, slot2, _ = t_bvh.closest_hit_bvh(tt, o, d, t_min, t_max)
    assert torch.equal(t2.view(torch.int32), t.view(torch.int32))
    assert torch.equal(slot2, slot)
    if (scene, kind) != ("soup", "grazing"):    # the soup's box is empty
        assert hit.float().mean() > 0.2           # on its faces


def test_pt_waves_walk_the_tree_on_the_card(cuda, bvh_scenes):
    """A path-traced frame of the room: one launch of the per-ray kernel
    a wave after bounce 0, none of the block walk's closest hit; under a
    recording profiler `pt.traverse` carries the walk's counters."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import port
    from gsrt_torch.models import path_tracer as t_pt
    from gsrt_torch.utils.profiling import TRACER
    from test_torch_tri_bvh import room_scene
    s, ps = room_scene(20_000, device=cuda)
    cfg = RenderConfig(width=96, height=64, samples=1, bounces=4,
                       has_sky=False, gamma_correction=False)
    cam = port.camera(s.view, cuda)
    _kernels.reset_launch_counts()
    img, flags = t_pt.render_path_traced(ps, cam, cfg, seed=5,
                                         primary_impl="binned",
                                         tri_max_pairs=1 << 16,
                                         return_flags=True)
    counts = _kernels.launch_counts()
    assert counts["closest_hit_bvh"] == cfg.bounces - 1
    assert counts["closest_hit_packed"] == 0
    assert not any(bool(v) for v in flags.values())
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = t_pt.render_path_traced(ps, cam, cfg, seed=5,
                                         primary_impl="binned",
                                         tri_max_pairs=1 << 16)
    rep = TRACER.report()
    TRACER.reset()
    assert torch.equal(traced, img)
    waves = [r["counters"] for r in rep if r["name"] == "pt.traverse"]
    assert len(waves) == cfg.bounces - 1
    assert all(w["tri_rays"] > 0 and w["tri_nodes"] >= w["tri_rays"]
               and w["tri_tests"] > 0 for w in waves)


def test_densify_event_on_card_matches_cpu(cuda):
    """One densify event (prunes, clones, splits, the budget binding) on
    CUDA tensors and on CPU tensors from the same NumPy inputs: the same
    report, every row and every Adam moment equal (the split children's
    means within 1e-6: A·n summed in another order), the step counts kept,
    and the optimiser holding the new parameters."""
    rng = np.random.default_rng(12)
    n = 20_000
    f32 = lambda a: np.asarray(a, np.float32)
    means = rng.uniform(-2, 2, (n, 3))
    logit = rng.normal(1.0, 1.5, n)
    logit[rng.random(n) < 0.1] = -8.0
    params = [f32(means), f32(np.log(rng.uniform(0.02, 0.3, (n, 3)))),
              f32(rng.normal(size=(n, 4))), f32(logit),
              f32(rng.normal(0, 0.3, (n, 1, 3)))]
    count = rng.integers(0, 20, n).astype(np.int32)
    grad = f32(rng.uniform(0, 1, n) * np.maximum(count, 1)
               * 10.0 ** rng.uniform(-5, -2, n))
    mu = [f32(rng.normal(0, 1e-2, p.shape)) for p in params]
    nu = [f32(rng.uniform(0, 1e-4, p.shape)) for p in params]
    out = []
    for dev in ("cpu", cuda):
        tp = params_from_numpy(*params, device=dev)
        opt = t_tr.make_optimizer(tp)
        opt_state_from_numpy(opt, mu, nu, [9] * 5)
        new, opt, stats, rep = t_dn.densify_and_prune(
            tp, opt, stats_from_numpy(grad, count, device=dev),
            grad_threshold=2e-4, scale_threshold=0.15, max_splats=n + 500,
            bucket=4096, seed=5)
        for f, g in zip(t_dn.FIELDS, opt.param_groups):
            assert g["params"][0] is getattr(new, f)
        out.append((rep, params_to_numpy(new), opt_state_to_numpy(opt),
                    stats_to_numpy(stats)))
    (rep_c, p_c, o_c, s_c), (rep_g, p_g, o_g, s_g) = out
    assert rep_c == rep_g and rep_c.n_split > 0 and rep_c.n_cloned > 0
    assert rep_c.n_after <= n + 500
    child = slice(rep_c.n_after - 2 * rep_c.n_split, rep_c.n_after)
    np.testing.assert_allclose(p_g[0][child], p_c[0][child], atol=1e-6,
                               rtol=0)
    p_g[0][child] = p_c[0][child]
    for g, c in zip(p_g, p_c):
        np.testing.assert_array_equal(g, c)
    for g, c in zip(o_g[0] + o_g[1] + list(s_g), o_c[0] + o_c[1] + list(s_c)):
        np.testing.assert_array_equal(g, c)
    assert o_g[2] == o_c[2] == [9] * 5


def test_render_reference_cuda_matches_cpu(cuda):
    """The k-buffer passes on the card against the CPU: passes and hits
    equal, trans and colour at the bounds the CPU tests hold the port to
    against the JAX package (rtol 1e-4 / atol 1e-5, 1e-3 / 1e-4)."""
    from gsrt_torch import REFERENCE_DEMO
    from gsrt_torch.scene import demo_gauss_splat
    scenes = [(demo_gauss_splat(16, 16, device="cpu"), REFERENCE_DEMO),
              (random_cloud(2000, seed=1, width=96, height=64,
                            device="cpu"),
               RenderConfig(width=96, height=64, max_passes=256))]
    for (c, cam), cfg in scenes:
        want = t_rt.render_reference(c, cam, cfg)
        got = t_rt.GaussianRayTracer(cfg, "reference", device=cuda)(c, cam)
        assert torch.equal(got.passes.cpu(), want.passes)
        assert torch.equal(got.hits.cpu(), want.hits)
        np.testing.assert_allclose(got.trans.cpu().numpy(),
                                   want.trans.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.color.cpu().numpy(),
                                   want.color.numpy(), rtol=1e-3, atol=1e-4)
        assert int(got.hits.max()) >= 2


def test_clustered_trace_cuda_matches_bruteforce(cuda):
    """Free rays through clustered splats on the card: against the brute
    force on the card (hits equal, trans rtol 1e-5 / atol 1e-6, colour
    rtol 1e-4 / atol 1e-5, no overflow) and against itself on the CPU."""
    from gsrt_torch.ops import splat_clusters as t_sc
    c, _ = random_cloud(3000, seed=0, extent=1.5, width=64, height=64,
                        device="cpu")
    cfg = RenderConfig(width=64, height=64, k=8)
    rng = np.random.default_rng(1)
    o = (rng.normal(size=(600, 3)) * 0.5 + [0, 0, -1.0]).astype(np.float32)
    d = (rng.normal(size=(600, 3)) * 0.3 + [0, 0, 1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    colors = torch.abs(torch.sin(c.means * 5.0))
    out = {}
    for dev in ("cpu", cuda):
        cd = c.to(dev)
        sc = t_sc.build_splat_clusters(cd, cfg, colors.to(dev), k=64, sup=4)
        ms = sc.clusters.sup_min.shape[0]
        ot, dt = torch.as_tensor(o, device=dev), torch.as_tensor(d,
                                                                 device=dev)
        out[str(dev)] = (
            t_sc.trace_gaussian_rays_clustered(sc, ot, dt, cfg, rb=128,
                                               s_max=ms),
            t_rt.trace_gaussian_rays(cd, ot, dt, cfg,
                                     colors=colors.to(dev)))
    (ct, cc, ch, covf), (bt, bc, bh) = (
        [a.cpu() for a in x] for x in out[str(cuda)])
    assert not bool(covf) and int(ch.max()) > 8
    assert torch.equal(ch, bh)
    np.testing.assert_allclose(ct.numpy(), bt.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cc.numpy(), bc.numpy(), rtol=1e-4, atol=1e-5)
    (pt, pc, ph, _), _ = out["cpu"]
    assert torch.equal(ph, ch)
    np.testing.assert_allclose(ct.numpy(), pt.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("payload", ["compact", "f32"])
def test_ellipse_expands_bitwise(cuda, payload, monkeypatch):
    """Both expands of ellipse spans (splats → tile rows, rows → pairs) on
    their real inputs, each bit-equal to its plain version, and the
    ellipse render on the card against the CPU's."""
    calls = []
    orig = t_pe.expand_pairs_fused

    def record(tab, base, max_pairs):
        calls.append((tab, base, max_pairs))
        return orig(tab, base, max_pairs)
    monkeypatch.setattr(t_pe, "expand_pairs_fused", record)
    cfg = RenderConfig(width=320, height=256, span_mode="ellipse",
                       stream="tile", payload=payload)
    c, cam = random_cloud(20_000, seed=2, width=320, height=256,
                          scale_range=(0.01, 0.06), device="cpu")
    cpu = t_rt.GaussianRayTracer(cfg, "tiled", device="cpu")(c, cam)
    calls.clear()
    gpu = t_rt.GaussianRayTracer(cfg, "tiled", device=cuda)(c, cam)
    assert len(calls) == 2 and not bool(gpu.overflow)
    for tab, base, mp in calls:
        assert tab.is_cuda
        assert torch.equal(orig(tab, base, mp),
                           t_pe.expand_pairs_plain(tab, base, mp))
    assert calls[0][0].shape[1] == c.n and calls[1][2] == \
        t_rt.GaussianRayTracer(cfg, "tiled", device="cpu").calibrate(c, cam)
    np.testing.assert_allclose(gpu.color.cpu().numpy(), cpu.color.numpy(),
                               atol=2e-3)


def test_sorted_bounce_waves_match_unsorted(cuda):
    """Coherence-sorting a bounce wave moves every ray to another row; its
    segment must not change. On the card `(a * b).sum(-1)` over rows of 3
    may sum in an order that depends on the row's address, which flipped
    grazing sphere hits of mirror_in_gaussians' sorted waves (0.9 on 7,635
    of 786,432 entries at 512x512, 8 bounces); the ray tests now sum
    left to right as elementwise ops."""
    from gsrt_torch.models import path_tracer as t_pt
    from gsrt_torch.ops.sh import eval_sh
    from gsrt_torch.ops.splat_clusters import build_splat_clusters
    from gsrt_torch.scene import mirror_in_gaussians
    scene, cloud, cam, _ = mirror_in_gaussians(256, 256, device=cuda)
    cfg = RenderConfig(width=256, height=256, bounces=4,
                       gamma_correction=False)
    colors = eval_sh(cloud.sh, t_rt.unit_dirs(cloud.means, cam.position),
                     0)
    sc = build_splat_clusters(cloud, cfg, colors, k=8, sup=2)
    kw = dict(gauss_clusters=sc, gauss_s_max=4, seed=0)
    srt = t_pt.render_path_traced(scene, cam, cfg, **kw)
    flat = t_pt.render_path_traced(scene, cam, cfg, sort_bounces=False, **kw)
    brute = t_pt.render_path_traced(scene, cam, cfg, seed=0, gaussians=cloud)
    assert torch.equal(srt, flat)
    np.testing.assert_allclose(srt.cpu().numpy(), brute.cpu().numpy(),
                               rtol=5e-3, atol=1e-3)


def _ulps(got: torch.Tensor, want: torch.Tensor) -> str:
    """Where two float columns differ in their bits: the count and the
    largest gap in units of the last place, for an assertion's message."""
    bad = got.view(torch.int32) != want.view(torch.int32)
    gi = got[bad].view(torch.int32).long()
    wi = want[bad].view(torch.int32).long()
    return (f"{int(bad.sum())} differ, at most {int((gi - wi).abs().max())}"
            f" ulp, first at {int(bad.nonzero()[0])}")


@pytest.mark.parametrize("dilation", [0.0, 0.3])
@pytest.mark.parametrize("k,degree", SH_CASES)
@pytest.mark.parametrize("conic_mode", ["standard", "reference"])
def test_project_kernel_bitwise(cuda, conic_mode, k, degree, dilation):
    """The projection kernel against its plain version on the card, bit
    for bit on all twelve columns, with tests/test_torch_project.py's
    edge cases; 3001 splats are 23 blocks of 128 and a partial one."""
    cloud, camera = edge_cloud(3001, k, seed=k + degree, device=cuda)
    cfg = edge_config(conic_mode, degree, dilation)
    before = _kernels.PROJECT.launches
    got = t_proj.project_splats(cloud, camera, cfg)
    assert _kernels.PROJECT.launches == before + 1
    want = t_proj.project_splats_plain(cloud, camera, cfg)
    for name, g, w in zip(t_proj.SplatColumns._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "alive":
            assert torch.equal(g, w), (name, int((g != w).sum()))
        else:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                (name, _ulps(g, w))
    assert got.alive.any() and not got.alive.all()


@pytest.mark.parametrize("alpha_threshold", [0.3, 1 / 7])
def test_project_kernel_other_alpha_thresholds(cuda, alpha_threshold):
    """PyTorch divides opacity by the threshold as the product with the
    threshold's reciprocal rounded from double: at 1/7 that is not the
    float32 reciprocal of float32(1/7). The kernel's extents and alive
    mask follow it bit for bit."""
    cloud, camera = edge_cloud(3001, 16, seed=5, device=cuda)
    cfg = edge_config("standard", 3, 0.0).replace(
        alpha_threshold=alpha_threshold)
    got = t_proj.project_splats(cloud, camera, cfg)
    want = t_proj.project_splats_plain(cloud, camera, cfg)
    for name in ("rx", "ry"):
        g, w = getattr(got, name), getattr(want, name)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
            (name, _ulps(g, w))
    assert torch.equal(got.alive, want.alive)


def test_project_kernel_unaligned_sh(cuda):
    """SH rows that do not start on 16 bytes (a view one float into its
    storage) give the same columns as aligned ones."""
    cloud, camera = edge_cloud(700, 16, device=cuda)
    store = torch.empty(cloud.sh.numel() + 1, device=cuda)
    sh = store[1:].view(cloud.sh.shape)
    sh.copy_(cloud.sh)
    assert sh.data_ptr() % 16 != 0
    cfg = edge_config("standard", 3, 0.0)
    got = t_proj.project_splats(cloud._replace(sh=sh), camera, cfg)
    for g, w in zip(got, t_proj.project_splats(cloud, camera, cfg)):
        assert torch.equal(g, w)


def test_project_kernel_launches_once_a_render(cuda):
    """A tiled frame and every render of a served frame launch the
    projection kernel once; a tiled training step never does (it projects
    under autograd)."""
    from gsrt_torch.scene import orbit_path
    from gsrt_torch.serving import ServingRenderer
    W, H = 320, 256
    cfg = RenderConfig(width=W, height=H)
    cloud, cam = random_cloud(20_000, seed=1, width=W, height=H,
                              device=cuda)

    def launched(fn):
        before = _kernels.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in
                     _kernels.launch_counts().items() if v != before[k]}

    tracer = t_rt.GaussianRayTracer(cfg, "tiled", device=cuda)
    tracer.calibrate(cloud, cam)
    out, counts = launched(lambda: tracer(cloud, cam))
    assert not bool(out.overflow)
    assert counts["project_splats"] == 1
    assert counts["blend_packed_group"] == 1

    path = orbit_path((0, 0, 6.0), 10.0, 6, height=2.0, width=W,
                      height_px=H, degrees=30, start_deg=200.0, device=cuda)
    srv = ServingRenderer(cfg, strict=True, device=cuda)

    def serve():
        for c in path:
            srv(cloud, c)
        srv.finish()
    _, counts = launched(serve)
    assert counts["project_splats"] == counts["blend_packed_tile"]
    assert counts["project_splats"] >= len(path)

    params = t_tr.init_params(cloud)
    opt = t_tr.make_optimizer(params)
    mp = t_rt.pair_bucket(int(t_rt.count_pairs_numpy(cloud, cam, cfg) * 1.1))
    _, counts = launched(lambda: t_tr.train_step_tiled(
        params, opt, out.color.detach(), cam, cfg, mp))
    assert "project_splats" not in counts
    assert counts["blend_backward"] == 1


@pytest.mark.parametrize("has_sky", [False, True], ids=["nosky", "sky"])
@pytest.mark.parametrize("tex", [False, True], ids=["untextured", "tex"])
@pytest.mark.parametrize("kind", WAVE_KINDS)
def test_pt_shade_kernel_bitwise(cuda, kind, tex, has_sky):
    """The shading kernel against its plain version on the card, the same
    draws (two generators seeded alike, left in the same state): orig,
    dirn, ray colour, out colour and active bit for bit, on rays of every
    material, live, retired, missing and parked, normals on both sides,
    glass at total internal reflection, with and without a texture colour
    and a sky; one launch a wave."""
    from gsrt_torch.models import path_tracer as t_pt
    from gsrt_torch.ops import pt_shade
    mats = materials(cuda)
    w = make_wave(kind, 4096 + 37, tex, cuda, seed=5)
    want, g_want = shade(t_pt._shade_plain, 9, mats, clone_wave(w), has_sky)
    before = _kernels.PT_SHADE.launches
    got_w = clone_wave(w)
    got, g_got = shade(pt_shade.shade_wave, 9, mats, got_w, has_sky)
    torch.cuda.synchronize()
    assert _kernels.PT_SHADE.launches == before + 1
    assert all(a is got_w[k] for a, k in zip(got, OUTPUTS))
    for name, a, b in zip(OUTPUTS, got, want):
        if a.dtype == torch.bool:
            assert torch.equal(a, b), name
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                f"{name}: {_ulps(a.reshape(-1), b.reshape(-1))}"
    assert torch.equal(g_got.get_state(), g_want.get_state())
    if kind == "glass_tir":     # most rays reflect, the others refract
        refl = (got[1] * w["n"]).sum(-1) < 0
        assert 0.5 < refl.float().mean().item() < 0.99


def test_pt_frame_shades_once_a_wave(cuda, monkeypatch):
    """A 16-bounce frame of a small room: one launch of the shading kernel
    a wave, `shade_waves` and `shade_fused` 16 under a recording profiler,
    and the frame bit-equal to the one shaded by the plain version on the
    card."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import port, tri_scene
    from gsrt_torch.interop import scene_from_numpy
    from gsrt_torch.models import path_tracer as t_pt
    from gsrt_torch.utils.profiling import TRACER
    s = tri_scene.build(3000, 64, 48)
    ps = t_pt.with_tri_table(scene_from_numpy(s.fields(), device=cuda))
    cfg = RenderConfig(width=64, height=48, samples=1, bounces=16,
                       has_sky=False, gamma_correction=False)
    cam = port.camera(s.view, cuda)
    kw = dict(seed=4, primary_impl="binned", tri_max_pairs=1 << 16)
    _kernels.reset_launch_counts()
    img = t_pt.render_path_traced(ps, cam, cfg, **kw)
    assert _kernels.launch_counts()["pt_shade"] == 16
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = t_pt.render_path_traced(ps, cam, cfg, **kw)
    rep = TRACER.report()
    TRACER.reset()
    assert torch.equal(traced, img)
    shades = [r["counters"] for r in rep if r["name"] == "pt.shade"]
    assert sum(c["shade_waves"] for c in shades) == 16
    assert sum(c["shade_fused"] for c in shades) == 16

    def plain(gen, mats, *wave):
        outs = (wave[4], wave[5], wave[7], wave[8], wave[6])
        for dst, src in zip(outs, t_pt._shade_plain(gen, mats, *wave)):
            dst.copy_(src)
        return outs
    monkeypatch.setattr(t_pt, "shade_wave", plain)
    _kernels.reset_launch_counts()
    want = t_pt.render_path_traced(ps, cam, cfg, **kw)
    assert _kernels.launch_counts()["pt_shade"] == 0
    assert torch.equal(img.view(torch.int32), want.view(torch.int32))
    assert img.std() > 0.05       # the light reached through the bounces


# --- the group stream's kernel route (csrc/tile_bin.cu) ---

BIN_W, BIN_H = 1920, 1080


def _assert_same_binning(got, want):
    """Every TileBinning field equal, bit for bit (floats as their bits)."""
    for f in t_tb.TileBinning._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        differ = int((a != b).sum())
        assert differ == 0, f"{f}: {differ} entries differ"


@pytest.fixture(scope="module")
def bin_scene():
    """A 200K-splat seeded cloud at the render cell's scales and three
    1080p orbit views of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    from gsrt_torch.scene import orbit_path
    dev = torch.device("cuda")
    cloud, _ = random_cloud(200_000, seed=11, width=BIN_W, height=BIN_H,
                            scale_range=(0.004, 0.03), device=dev)
    cams = orbit_path((0, 0, 6.0), 10.0, 3, height=2.0, width=BIN_W,
                      height_px=BIN_H, start_deg=200.0, device=dev)
    return cloud, cams


def _bin_columns(cloud, cam, tile):
    cfg = RenderConfig(width=BIN_W, height=BIN_H, tile_w=tile[0],
                       tile_h=tile[1])
    c = t_rt._precompute(cloud, cam, cfg)
    cols = [c.depth, c.m2x, c.m2y, c.qa, c.qb, c.qc, cloud.opacity, c.cr,
            c.cg, c.cb, c.rx, c.ry, c.alive]
    k = t_tb.group_rows_k(t_tb.tile_extent(BIN_W, BIN_H, *tile)[0])
    pairs, units = t_rt.count_units_numpy(cloud, cam, cfg, k)
    return cols, pairs, units


def _edge_columns(n, seed, device):
    """Seeded columns of splats off screen, straddling every edge and
    corner, inside, dead, zero-extent, behind, with colours across both
    tiers and past them."""
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)  # noqa
    m2x = torch.where(torch.rand(n, generator=g) < 0.5, u(-400, 120),
                      u(BIN_W - 120, BIN_W + 400))
    m2y = torch.where(torch.rand(n, generator=g) < 0.5, u(-400, 80),
                      u(BIN_H - 80, BIN_H + 400))
    inside = torch.rand(n, generator=g) < 0.3
    m2x = torch.where(inside, u(0, BIN_W), m2x)
    m2y = torch.where(inside, u(0, BIN_H), m2y)
    rx, ry = u(-2, 150), u(-2, 150)
    rx = torch.where(torch.rand(n, generator=g) < 0.05, 0.0, rx)
    qa, qc = u(1e-4, 2.0), u(1e-4, 2.0)
    qb = u(-1, 1) * torch.sqrt(qa * qc)
    cols = [u(-1, 50), m2x, m2y, qa, qb, qc, u(-0.1, 1.1), u(-0.2, 4.5),
            u(-0.2, 4.5), u(-0.2, 4.5), rx, ry,
            torch.rand(n, generator=g) < 0.8]
    return [c.to(device) for c in cols]


BIN_CASES = ["orbit0", "orbit1", "orbit2", "pairs_overflow",
             "units_overflow", "no_live", "edges", "cull", "tiles16x16",
             "tiles64x16", "tiles16x4", "tiles16x2"]


@pytest.mark.parametrize("case", BIN_CASES)
def test_group_bin_kernels_bitwise(cuda, bin_scene, case):
    """The kernel route against the plain group route on the card, every
    TileBinning field bit for bit: three 1080p orbit views of 200K splats,
    each buffer cut below its need, no live splat, splats off screen and
    across the edges, serving's cull, and the 16x16 and 64x16 grids,
    16x4 (270 groups: more keys than bin_units has threads) and 16x2 (a
    121x541 corner grid, past shared memory: bin_prep keeps it in device
    memory)."""
    cloud, cams = bin_scene
    tile = {"tiles16x16": (16, 16), "tiles64x16": (64, 16),
            "tiles16x4": (16, 4), "tiles16x2": (16, 2)}.get(case, (32, 16))
    view = int(case[-1]) if case.startswith("orbit") else 0
    cols, pairs, units = _bin_columns(cloud, cams[view], tile)
    if case == "edges":
        cols = _edge_columns(20_000, 7, cuda)
        pairs = units = 1 << 21
    if case == "no_live":
        cols[12] = torch.zeros_like(cols[12])
    kw = dict(width=BIN_W, height=BIN_H, tile_w=tile[0], tile_h=tile[1],
              max_pairs=t_rt.pair_bucket(int(pairs * 1.1)),
              max_units=t_rt.pair_bucket(int(units * 1.1)),
              carry_depth=case in ("orbit1", "cull"))
    if case == "pairs_overflow":
        kw["max_pairs"] = pairs // 2
    if case == "units_overflow":
        kw["max_units"] = units // 2
    if case == "cull":
        ntx, nty = t_tb.tile_extent(BIN_W, BIN_H, *tile)
        gen = torch.Generator().manual_seed(3)
        kw["cutoff_map"] = (5 + 20 * torch.rand(ntx * nty, generator=gen)
                            ).to(cuda)
    before = _kernels.launch_counts()
    got = t_tb.build_tile_binning(
        *cols, width=kw["width"], height=kw["height"], tile_w=tile[0],
        tile_h=tile[1], max_pairs=kw["max_pairs"], max_rows=kw["max_units"],
        cutoff_map=kw.get("cutoff_map"), carry_depth=kw["carry_depth"])
    after = _kernels.launch_counts()
    want = t_tb.group_stream_plain(*cols, **kw)
    torch.cuda.synchronize()
    for name in ("bin_prep", "bin_gather", "bin_units",
                 "expand_pairs_fused", "expand_pairs_binned"):
        assert after[name] == before[name] + 1, name
    _assert_same_binning(got, want)
    total, over = int(want.total_pairs), bool(want.overflow)
    if case == "no_live":
        assert total == 0 and not over
    elif case in ("pairs_overflow", "units_overflow"):
        assert over
    else:
        assert total > 0 and not over


def test_group_bin_render_matches_plain_route(cuda, bin_scene, monkeypatch):
    """A tiled frame through GaussianRayTracer with the kernel route is
    bit-equal to the frame with the plain group route, and its binning
    launches bin_prep once and counts group_bin_fused 1 under a recording
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from gsrt_torch.utils.profiling import TRACER
    cloud, cams = bin_scene
    cfg = RenderConfig(width=BIN_W, height=BIN_H)
    tracer = t_rt.GaussianRayTracer(cfg, "tiled", device=cuda)
    tracer.calibrate(cloud, cams[0])
    TRACER.reset()
    launched = _kernels.BIN_PREP.launches
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            got = tracer(cloud, cams[0])
        binnings = [s for s in TRACER.report()
                    if s["name"] == "render.binning"]
    finally:
        TRACER.reset()
    assert _kernels.BIN_PREP.launches == launched + 1
    assert [s["counters"]["group_bin_fused"] for s in binnings] == [1]
    monkeypatch.setattr(t_tb, "_bin_group_cuda", t_tb.group_stream_plain)
    before = _kernels.BIN_PREP.launches
    want = tracer(cloud, cams[0])
    torch.cuda.synchronize()
    assert _kernels.BIN_PREP.launches == before
    assert not bool(got.overflow) and not bool(want.overflow)
    for f in ("color", "trans", "hits", "passes"):
        a, b = getattr(got, f), getattr(want, f)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b), f
