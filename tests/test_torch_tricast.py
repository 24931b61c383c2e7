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
t at rtol 1e-5, ids equal wherever the brute-force t is not tied.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
