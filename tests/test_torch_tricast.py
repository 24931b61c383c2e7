"""gsrt_torch's screen-tile binned primary cast (`ops.tri_binning`) held
against the JAX package on the same NumPy inputs (CPU; the JAX cast kernel
in interpret mode, the port's cast through its plain version).

Tolerances: tile_start, tile_count, total_pairs, overflow and the NumPy
pair counts are compared exactly. The payload's 11 rows are compared bit
for bit per tile as multisets of columns: the port's depth sort is stable
and the JAX package's is not, so the order of equal-zmin triangles inside
a tile is not contractual. Cast t at rtol 1e-5 (XLA may contract
Möller–Trumbore's products into FMAs, the port rounds each on its own),
the hit mask equal and triangle ids equal on at least 99.9% of pixels (a
last-ulp difference in t can pick the other triangle of a near tie). The
port's cast against its own brute-force Möller–Trumbore sweep: hits equal,
t at rtol 1e-5, ids equal wherever the brute-force t is not tied. The CUDA
kernel's warp cull (`warp_cull`, its arithmetic) is held exactly: no
(warp, pair) it removes has a lane that would take the pair, on random and
adversarial warps and triangles.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core import types as j_types
from gsrt.ops import tri_binning as j_tbin

from gsrt_torch.interop import camera_from_numpy
from gsrt_torch.ops import primitives as t_prim
from gsrt_torch.ops import tri_binning as t_tbin

TILE = dict(tile_w=16, tile_h=8)
# (triangles, seed, width, height): 700 triangles put more than one
# 128-pair chunk in the central tiles, so the early exit is exercised
SCENES = {"soup700": (700, 0, 64, 48), "soup300": (300, 3, 48, 32),
          "soup80": (80, 5, 64, 48)}


def _soup(n, seed, spread=2.0, size=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    a = c + rng.normal(0, size, (n, 3)).astype(np.float32)
    b = c + rng.normal(0, size, (n, 3)).astype(np.float32)
    return c, a, b


def _cameras(width, height):
    jcam = j_types.make_camera(j_types.look_at((0, 0, -6.0), (0, 0, 0.0)),
                               50.0, width, height)
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), width, height, device="cpu")
    return jcam, cam


def _dirs(jcam, seed):
    """Jittered unit camera-ray directions [H·W, 3] in framebuffer order."""
    H, W = jcam.height, jcam.width
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W]
    p = np.stack([xs.reshape(-1), ys.reshape(-1)], -1) + rng.random((H * W,
                                                                     2))
    d = np.stack([(p[:, 0] - float(jcam.cx)) / float(jcam.fx),
                  (p[:, 1] - float(jcam.cy)) / float(jcam.fy),
                  np.ones(H * W)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c2w = np.linalg.inv(np.asarray(jcam.view, np.float64))
    return (d @ c2w[:3, :3].T).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def binnings():
    """Both packages' binnings of each scene, rect and exact spans."""
    out = {}
    for name, (n, seed, W, H) in SCENES.items():
        v = _soup(n, seed)
        jcam, cam = _cameras(W, H)
        for exact in (False, True):
            kw = dict(TILE, max_pairs=1 << 14, span_exact=exact)
            out[name, exact] = (
                v, jcam, cam,
                j_tbin.build_tri_binning(*map(jnp.asarray, v), jcam, **kw),
                t_tbin.build_tri_binning(*map(_t, v), cam, **kw))
    return out


@pytest.fixture(scope="module")
def casts(binnings):
    """Both packages' casts of jittered camera rays through each binning."""
    out = {}
    for (name, exact), (v, jcam, cam, jb, tb) in binnings.items():
        dirs = _dirs(jcam, 1)
        origin = np.asarray(jcam.position, np.float32)
        kw = dict(width=jcam.width, height=jcam.height, **TILE)
        j = j_tbin.cast_primary(jb, jnp.asarray(dirs), jnp.asarray(origin),
                                interpret=True, **kw)
        stats = {}
        t = t_tbin.cast_primary_plain(tb, _t(dirs), _t(origin), stats=stats,
                                      **kw)
        out[name, exact] = (dirs, origin, j, t, stats)
    return out


def _canonical(payload, tile_start, total):
    """The payload's first `total` columns [11, total] sorted by (tile,
    zmin, triangle id): the order inside a tile up to equal-zmin ties."""
    ts = np.asarray(tile_start)
    tile = np.repeat(np.arange(ts.shape[0] - 1), np.diff(ts))
    p = np.asarray(payload)[:11, :total]
    ids = p[9].view(np.int32)
    return p[:, np.lexsort((ids, p[10], tile))]


@pytest.mark.parametrize("exact", [False, True], ids=["rect", "exact"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_build_tri_binning_matches_jax(binnings, scene, exact):
    _, _, _, jb, tb = binnings[scene, exact]
    for f in ("tile_start", "tile_count", "total_pairs", "overflow"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), f)
    total = int(tb.total_pairs)
    assert 0 < total <= tb.payload.shape[1] and not bool(tb.overflow)
    assert tb.payload.shape == (11, 1 << 14)
    np.testing.assert_array_equal(
        _canonical(tb.payload.view(torch.int32).numpy(), tb.tile_start,
                   total).view(np.int32),
        _canonical(np.asarray(jb.payload).view(np.int32), jb.tile_start,
                   total).view(np.int32))
    # each tile's pairs ascend in zmin; dead columns are inert
    zmin, ts = tb.payload[10].numpy(), tb.tile_start.numpy()
    for a, b in zip(ts[:-1], ts[1:]):
        assert (np.diff(zmin[a:b]) >= 0).all()
    dead = tb.payload[:, total:]
    assert (dead[:9] == 0).all() and (dead[10] == np.float32(3.4e38)).all()
    assert (dead[9].view(torch.int32) == t_tbin._ID_SENTINEL).all()


@pytest.mark.parametrize("exact", [False, True], ids=["rect", "exact"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_count_tri_pairs_numpy_matches_jax(binnings, scene, exact):
    v, jcam, cam, _, tb = binnings[scene, exact]
    kw = dict(TILE, span_exact=exact)
    n = t_tbin.count_tri_pairs_numpy(*map(_t, v), cam, **kw)
    assert n == j_tbin.count_tri_pairs_numpy(*v, jcam, **kw)
    # f64 against the binning's f32: the odd floor at a tile boundary
    assert abs(n - int(tb.total_pairs)) <= max(4, n // 100)


@pytest.mark.parametrize("exact", [False, True], ids=["rect", "exact"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_cast_primary_matches_jax(casts, scene, exact):
    _, _, (j_t, j_id), (t_t, t_id), _ = casts[scene, exact]
    j_t, j_id = np.asarray(j_t), np.asarray(j_id)
    t_t, t_id = t_t.numpy(), t_id.numpy()
    hit = j_t < 3e38
    np.testing.assert_array_equal(t_t < 3e38, hit)
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(t_t[hit], j_t[hit], rtol=1e-5)
    assert (t_t[~hit] == np.float32(3.4e38)).all()
    assert (t_id[~hit] == t_tbin._ID_SENTINEL).all()
    assert (t_id == j_id).mean() >= 0.999


@pytest.mark.parametrize("scene", list(SCENES))
def test_cast_primary_matches_brute_force(binnings, casts, scene):
    """The rect cast is conservative: each pixel's nearest triangle is in
    its tile's list, so the cast equals a sweep over every triangle."""
    v, _, _, _, _ = binnings[scene, False]
    dirs, origin, _, (t_t, t_id), _ = casts[scene, False]
    t_all, _, _ = t_prim.ray_triangle(
        _t(np.broadcast_to(origin, dirs.shape)), _t(dirs), *map(_t, v),
        1e-3, 1e4)
    bt, bi = t_all.min(1)
    H, W = t_t.shape
    bt, bi = bt.reshape(H, W).numpy(), bi.reshape(H, W).numpy()
    hit = np.isfinite(bt)
    np.testing.assert_array_equal(t_t.numpy() < 3e38, hit)
    np.testing.assert_allclose(t_t.numpy()[hit], bt[hit], rtol=1e-5)
    with np.errstate(invalid="ignore"):      # inf - inf off the hits
        near = (np.abs(t_all.numpy() - bt.reshape(-1, 1))
                <= 1e-5 * np.abs(bt.reshape(-1, 1))).sum(1).reshape(H, W)
    assert (t_id.numpy() == bi)[hit & (near == 1)].all()


def test_cast_early_exit_skips_chunks(binnings, casts):
    """Pairs ascend in zmin, so once every pixel of a tile holds a hit
    nearer than a chunk's smallest zmin the chunk is skipped."""
    _, _, _, _, tb = binnings["soup700", False]
    ts = tb.tile_start.numpy()
    n = np.diff(ts)
    chunks = int(((n + t_tbin.CHUNK - 1) // t_tbin.CHUNK).sum())
    stats = casts["soup700", False][4]
    assert n.max() > t_tbin.CHUNK
    assert 0 < stats["chunks"] < chunks
    assert stats["pairs"] < int(tb.total_pairs)


def test_near_plane_crosser_covered():
    """A triangle reaching behind the camera stays hittable."""
    v = (np.float32([[0.0, -1.0, -1.0]]), np.float32([[0.0, 1.0, 4.0]]),
         np.float32([[1.5, 0.0, 4.0]]))
    jcam = j_types.make_camera(
        j_types.look_at((0, 0, -2.0), (0.2, 0, 1.0)), 60.0, 32, 32)
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), 32, 32, device="cpu")
    tb = t_tbin.build_tri_binning(*map(_t, v), cam, max_pairs=1 << 8,
                                  **TILE)
    dirs = _dirs(jcam, 2)
    t, _ = t_tbin.cast_primary(tb, _t(dirs), cam.position, width=32,
                               height=32, **TILE)
    t_all, _, _ = t_prim.ray_triangle(cam.position.expand(32 * 32, 3),
                                      _t(dirs), *map(_t, v), 1e-3, 1e4)
    hit = torch.isfinite(t_all[:, 0]).reshape(32, 32)
    assert hit.any()
    assert torch.equal(t < 3e38, hit)


def test_overflow_and_exact_span_limit():
    v = _soup(500, 1)
    _, cam = _cameras(64, 48)
    b = t_tbin.build_tri_binning(*map(_t, v), cam, max_pairs=64, **TILE)
    assert bool(b.overflow) and int(b.total_pairs) > 64
    assert int(b.tile_start[-1]) <= 64
    _, tall = _cameras(16, 8 * 256)
    with pytest.raises(ValueError, match="nty"):
        t_tbin.build_tri_binning(*map(_t, v), tall, max_pairs=64,
                                 span_exact=True, **TILE)


# --- the cast kernel's warp cull and the order it reads (no JAX) ---

CULL_CASES = ("random", "grazing", "near_plane", "zero_area", "t_limits",
              "non_finite")
CULL_T = (0.5, 5.0)          # t_min, t_max of the cull cases


def _cull_case(kind, seed, warps=48, pairs=256):
    """Warps of 32 directions around an axis each (a few lanes outside
    the image, direction 0; warps 2-5 one direction) and triangles seen
    along those axes, per kind: random; grazing (planes nearly holding
    the axis, |det| near 1e-12); crossing the origin's plane; zero-area;
    at t_min and t_max; with non-finite vertices and directions. Returns (d [warps, 32, 3],
    in_image [warps, 32], v0, e1, e2 [pairs, 3]) as f32 tensors."""
    rng = np.random.default_rng(seed)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa
    axis = unit(rng.normal(size=(warps, 1, 3)))
    spread = 10.0 ** rng.uniform(-3.5, -1.3, (warps, 1, 1))
    spread[2:6] = 0.0                           # one direction a warp
    d = unit(axis + spread * rng.normal(size=(warps, 32, 3)))
    in_image = rng.random((warps, 32)) > 0.1
    in_image[:2] = False                        # warps of padding alone
    in_image[2:6] = True
    d[~in_image] = 0.0
    w = rng.integers(0, warps, pairs)           # the warp a pair aims at
    a = axis[w, 0]
    dist = rng.uniform(1.0, 8.0, (pairs, 1))
    size = dist * np.maximum(spread[w, 0], 1e-2) * rng.uniform(
        0.5, 4.0, (pairs, 1))
    off = spread[w, 0] * dist * rng.normal(0, 1.5, (pairs, 3))
    centre = a * dist + off
    e1 = rng.normal(size=(pairs, 3)) * size
    e2 = rng.normal(size=(pairs, 3)) * size
    if kind == "grazing":
        n = unit(np.cross(a, rng.normal(size=(pairs, 3))))
        s = 10.0 ** rng.uniform(-6.5, -1, (pairs, 1))
        e1 = unit(np.cross(n, rng.normal(size=(pairs, 3)))) * s
        e2 = unit(np.cross(n, e1)) * s + n * s * 10.0 ** rng.uniform(
            -6, -1, (pairs, 1))
        centre = a * dist + off * 1e-2
    elif kind == "near_plane":
        centre = a * rng.uniform(-0.05, 0.05, (pairs, 1)) + off
        e1 = e1 + a * rng.uniform(-2, 2, (pairs, 1))
    elif kind == "zero_area":
        e2 = np.where(rng.random((pairs, 1)) < 0.5, 0.0,
                      e1 * rng.uniform(-2, 2, (pairs, 1)))
    elif kind == "t_limits":
        t = np.where(rng.random((pairs, 1)) < 0.5, CULL_T[0], CULL_T[1])
        centre = a * t * rng.uniform(0.999, 1.001, (pairs, 1)) + off * 1e-3
        e1, e2 = e1 * t / dist, e2 * t / dist
    elif kind == "non_finite":
        bad = np.array([np.inf, -np.inf, np.nan])
        for arr in (centre, e1, e2):
            pick = rng.random(arr.shape) < 0.05
            arr[pick] = rng.choice(bad, int(pick.sum()))
        pick = (rng.random((warps, 32, 3)) < 0.02) & in_image[..., None]
        d[pick] = rng.choice(bad, int(pick.sum()))
    with np.errstate(invalid="ignore"):
        v0 = centre - (e1 + e2) / 3
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa
    return f32(d), torch.as_tensor(in_image), f32(v0), f32(e1), f32(e2)


@pytest.mark.parametrize("kind", CULL_CASES)
def test_warp_cull_is_exact(kind):
    """No (warp, pair) that the cast kernel's cull removes has a lane
    that accepts the pair, or, with the depth bound, one that accepts it
    at a t no larger than the lane's min(best t, running minimum); every
    lane's rounded det, u, v, u + v and t lie in the cull's intervals. The
    cull is the kernel's arithmetic (`t_tbin.warp_cull`), the lanes the
    kernel's per-lane rounding (`t_tbin.moller_trumbore`)."""
    d, in_image, v0, e1, e2 = _cull_case(kind, CULL_CASES.index(kind))
    t_min, t_max = CULL_T
    col = lambda a: tuple(a[:, i][None, None, :] for i in range(3))  # noqa
    rec = t_tbin.pair_records(col(v0), col(e1), col(e2))  # origin 0
    lanes = t_tbin.moller_trumbore(
        tuple(d[..., i:i + 1] for i in range(3)), rec, t_min, t_max)
    ok, t = lanes["ok"], lanes["t"]                  # [warps, 32, pairs]
    assert not ok[~in_image].any()                   # padding lanes
    box = tuple((lo[:, None, None], hi[:, None, None])
                for lo, hi in t_tbin.warp_boxes(d, in_image))
    # lanes with a NaN direction stay out of the box: they accept nothing
    assert not ok[torch.isnan(d).any(-1)].any()
    inf = torch.full((d.shape[0], 1, 1), np.inf)
    cut = t_tbin.warp_cull(box, rec, t_min, t_max, inf)[:, 0]
    assert not (cut[:, None, :] & ok).any()
    assert 0 < cut.float().mean() < 1
    assert ok.any() or kind == "zero_area"
    # the depth bound: a lane's min(best t, running minimum), random
    rng = np.random.default_rng(7)
    mu = torch.as_tensor(rng.uniform(t_min, 2.0, (d.shape[0], 32, 1)),
                         dtype=torch.float32)
    mu = torch.where(torch.as_tensor(rng.random(mu.shape) < 0.005),
                     torch.full_like(mu, 3.4e38), mu)
    # ties: warps 2-5 hold one direction, so their intervals are points;
    # their lanes' bound is the t of the first pair they accept
    ties = 0
    for w in range(2, 6):
        hit = ok[w, 0].nonzero()[:, 0]
        if hit.numel():
            mu[w] = t[w, 0, hit[0]]
            ties += 1
    assert ties or kind == "zero_area"
    bound = torch.where(in_image[..., None], mu,
                        torch.full_like(mu, -np.inf)).amax(1, True)
    cut_d = t_tbin.warp_cull(box, rec, t_min, t_max, bound)[:, 0]
    assert not (cut_d[:, None, :] & ok & (t <= mu)).any()
    assert (cut_d | ~cut).all()
    assert (cut_d & ~cut).any() or kind in ("near_plane", "zero_area")
    # enclosure, lane by lane, where the lane's value is a number
    iv = t_tbin.cast_intervals(box, rec)
    inside = in_image & ~torch.isnan(d).any(-1)
    inside = inside[..., None].expand_as(ok)

    def held(name, val, where):
        lo, hi = (e.expand_as(val) for e in iv[name])
        w = where & inside & ~torch.isnan(val) & ~torch.isnan(lo) \
            & ~torch.isnan(hi)
        assert ((lo[w] <= val[w]) & (val[w] <= hi[w])).all(), name
    everywhere = torch.ones_like(ok)
    held("det", lanes["det"], everywhere)
    signed = iv["signed"].expand_as(ok)
    for name in ("u", "v", "t"):
        held(name, lanes[name], signed)
    u_lo, v_lo = (iv[k][0].expand_as(ok) for k in ("u", "v"))
    uv, lo = lanes["u"] + lanes["v"], u_lo + v_lo
    w = signed & inside & ~torch.isnan(uv) & ~torch.isnan(lo)
    assert (lo[w] <= uv[w]).all()


@pytest.mark.parametrize("exact", [False, True], ids=["rect", "exact"])
def test_zmin_ascends_in_tile_segments(exact):
    """build_tri_binning sorts each tile's pairs by ascending zmin, near-
    plane crossers and off-screen triangles included, so once a cast skips
    a chunk it skips the rest of the tile; a binning that overflowed
    max_pairs does not keep that order, so the kernel does not rely on
    it."""
    v0, v1, v2 = _soup(600, 11, spread=3.0, size=0.8)
    v0[:20, 2] = -7.5                # behind the camera: near-plane crossers
    _, cam = _cameras(80, 48)
    kw = dict(TILE, span_exact=exact)
    b = t_tbin.build_tri_binning(*map(_t, (v0, v1, v2)), cam,
                                 max_pairs=1 << 15, **kw)
    assert not bool(b.overflow)
    zmin, ts = b.payload[10].numpy(), b.tile_start.numpy()
    seg = np.repeat(np.arange(ts.shape[0] - 1), np.diff(ts))
    step = np.diff(zmin[:ts[-1]])
    assert (np.diff(ts) > t_tbin.CHUNK).any()
    assert (step[seg[1:] == seg[:-1]] >= 0).all()
    small = t_tbin.build_tri_binning(*map(_t, (v0, v1, v2)), cam,
                                     max_pairs=int(b.total_pairs) // 2,
                                     **kw)
    zs, tss = small.payload[10].numpy(), small.tile_start.numpy()
    seg = np.repeat(np.arange(tss.shape[0] - 1), np.diff(tss))
    assert bool(small.overflow)
    assert (np.diff(zs[:tss[-1]])[seg[1:] == seg[:-1]] < 0).any()


def test_cast_stats_count_culled_steps(binnings, casts):
    """The plain cast counts the (warp, pair) steps of the chunks it
    casts and those the kernel's warp cull removes."""
    for name in SCENES:
        _, _, _, _, tb = binnings[name, False]
        stats = casts[name, False][4]
        nw = TILE["tile_w"] * TILE["tile_h"] // t_tbin.WARP
        assert stats["warp_steps"] == nw * stats["pairs"]
        assert 0 < stats["culled_steps"] < stats["warp_steps"]
