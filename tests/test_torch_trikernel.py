"""gsrt_torch's Morton codes, clusters, triangle table, visit planning and
packed-cluster traversal (`ops.morton`, `ops.clusters`, `ops.tri_kernel`)
held against the JAX package on the same NumPy inputs (CPU; the JAX
traversal kernel in interpret mode).

Tolerances: Morton codes, cluster orders, the table's bounds and
geometry, block offsets, visit totals and each block's visit set are
compared exactly (the visit order among equal entry distances is not
contractual: the JAX sort is unstable). Closest-hit t at rtol 1e-5 (the
two packages round Möller–Trumbore's sums in different orders), triangle
ids equal wherever the JAX t is not tied within that tolerance, and the
executed visits per block equal. Any hit: the hit mask equal, each
returned t a hit of the returned triangle (rtol 1e-5) inside (t_min,
t_max).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.ops import clusters as j_cl
from gsrt.ops import morton as j_morton
from gsrt.ops import primitives as j_prim
from gsrt.ops import tri_kernel as j_tk

from gsrt_torch.ops import clusters as t_cl
from gsrt_torch.ops import morton as t_morton
from gsrt_torch.ops import tri_kernel as t_tk


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _soup(n, spread, tri_size, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    v1 = base + rng.uniform(-tri_size, tri_size, (n, 3)).astype(np.float32)
    v2 = base + rng.uniform(-tri_size, tri_size, (n, 3)).astype(np.float32)
    return base, v1, v2


def _layers(layers, per_side, size=4.0, tilt=(0.11, 0.03)):
    """`layers` parallel planes z = layer + tilt · (x, y) of per_side²
    quads, two triangles each. The tilt gives every super-cluster its own
    entry distance, so no two visits of a block tie on it."""
    tris = []
    step = size / per_side
    for li in range(layers):
        for iy in range(per_side):
            for ix in range(per_side):
                x0, y0 = -size / 2 + ix * step, -size / 2 + iy * step
                x1, y1 = x0 + step, y0 + step
                tris.append(([x0, y0, li], [x1, y0, li], [x0, y1, li]))
                tris.append(([x1, y1, li], [x0, y1, li], [x1, y0, li]))
    a = np.float32(tris)
    a[..., 2] += tilt[0] * a[..., 0] + tilt[1] * a[..., 1]
    return a[:, 0], a[:, 1], a[:, 2]


def _rays(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "beam":       # coherent camera-like bundle
        R = 300
        o = np.float32([[0, 0, -3]]) + rng.uniform(-0.2, 0.2, (R, 3))
        d = np.float32([[0, 0, 1]]) + rng.uniform(-0.4, 0.4, (R, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.full(R, 1e4)
    elif kind == "layers":   # front-to-back early exit through 8 layers
        R = 256
        o = np.float32([[0, 0, -5]]) + rng.uniform(-0.5, 0.5, (R, 3))
        d = np.float32([[0, 0, 1]]) + rng.uniform(-0.05, 0.05, (R, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tmax = np.full(R, 1e4)
    else:                    # scattered bounce-like rays, per-ray t_max
        R = 256
        o = rng.uniform(-1.2, 1.2, (R, 3))
        d = rng.normal(size=(R, 3))
        tmax = rng.uniform(0.5, 5.0, R)
    return (o.astype(np.float32), d.astype(np.float32),
            tmax.astype(np.float32))


SCENES = {"soup": lambda: _soup(700, 1.0, 0.1, 0),
          "layers": lambda: _layers(8, 24)}
CASES = [("soup", "beam"), ("layers", "layers"), ("soup", "scatter")]


@pytest.fixture(scope="module")
def tables():
    out = {}
    for name, make in SCENES.items():
        v = make()
        out[name] = (v, j_tk.build_tri_table(*map(jnp.asarray, v),
                                             jnp.zeros(len(v[0]), jnp.int32)),
                     t_tk.build_tri_table(*map(_t, v)))
    return out


@pytest.fixture(scope="module")
def traversals(tables):
    """Both packages' closest_hit_packed per case and mode, rb = 128."""
    out = {}
    for scene, kind in CASES:
        v, jt, tt = tables[scene]
        o, d, tmax = _rays(kind, 1)
        for any_hit in (False, True):
            j = j_tk.closest_hit_packed(jt, jnp.asarray(o), jnp.asarray(d),
                                        1e-3, jnp.asarray(tmax), rb=128,
                                        any_hit=any_hit, interpret=True)
            t = t_tk.closest_hit_packed(tt, _t(o), _t(d), 1e-3, _t(tmax),
                                        rb=128, any_hit=any_hit)
            out[scene, kind, any_hit] = (j, t)
    return out


@pytest.mark.parametrize("bounds", [False, True])
def test_morton3d_matches_jax(bounds):
    rng = np.random.default_rng(0)
    p = rng.normal(size=(5000, 3)).astype(np.float32)
    lo, hi = (np.float32([-1, -1, -1]), np.float32([1, 1, 1])) if bounds \
        else (None, None)
    j = j_morton.morton3d(jnp.asarray(p), *(None if a is None else
                                            jnp.asarray(a) for a in (lo, hi)))
    t = t_morton.morton3d(_t(p), *(None if a is None else _t(a)
                                   for a in (lo, hi)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def test_build_clusters_order_matches_jax():
    """Quantised centres: Morton codes tie often, and the stable sort must
    keep the JAX package's order exactly."""
    rng = np.random.default_rng(1)
    q = (rng.integers(0, 40, (3000, 3)) / 7).astype(np.float32)
    jc, jo = j_cl.build_clusters(jnp.asarray(q), jnp.asarray(q + 0.1),
                                 k=128, sup=8)
    tc, to = t_cl.build_clusters(_t(q), _t(q + 0.1), k=128, sup=8)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    for name in ("cl_min", "cl_max", "sup_min", "sup_max", "valid"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))


@pytest.mark.parametrize("scene", list(SCENES))
def test_build_tri_table_matches_jax(tables, scene):
    _, jt, tt = tables[scene]
    np.testing.assert_array_equal(tt.order.numpy(), np.asarray(jt.order))
    np.testing.assert_array_equal(tt.sup_min.numpy(), np.asarray(jt.sup_min))
    np.testing.assert_array_equal(tt.sup_max.numpy(), np.asarray(jt.sup_max))
    # the TPU table [MS·K, SUP·16]: sublane = triangle, lanes = (cluster,
    # feature); features 0-8 geometry, 10-15 the cluster AABB
    ms = tt.sup_min.shape[0]
    jtab = np.asarray(jt.table).reshape(ms, t_tk.K, t_tk.SUP, 16)
    jtab = jtab.transpose(0, 2, 3, 1).reshape(ms * t_tk.SUP, 16, t_tk.K)
    np.testing.assert_array_equal(tt.table.numpy(), jtab[:, :9])
    np.testing.assert_array_equal(tt.cl_min.numpy(), jtab[:, 10:13, 0])
    np.testing.assert_array_equal(tt.cl_max.numpy(), jtab[:, 13:16, 0])


@pytest.mark.parametrize("scene,kind", CASES)
def test_plan_visits_matches_jax(tables, scene, kind):
    _, jt, tt = tables[scene]
    o, d, tmax = _rays(kind, 2)
    R = o.shape[0] - o.shape[0] % 64
    o, d, tmax = o[:R], d[:R], tmax[:R]
    tmin = np.full(R, 1e-3, np.float32)
    mv = (R // 64) * jt.sup_min.shape[0]
    j = j_tk.plan_visits(*map(jnp.asarray, (o, d, tmin, tmax)), jt.sup_min,
                         jt.sup_max, 64, mv)
    t = t_tk.plan_visits(*map(_t, (o, d, tmin, tmax)), tt.sup_min,
                         tt.sup_max, 64, mv)
    bs = np.asarray(j.block_start)
    np.testing.assert_array_equal(t.block_start.numpy(), bs)
    assert int(t.total) == int(j.total) and bool(t.overflow) == \
        bool(j.overflow)
    for b in range(R // 64):
        s = slice(bs[b], bs[b + 1])
        assert sorted(t.visit.numpy()[s]) == sorted(np.asarray(j.visit)[s])
        # front to back: each block's entry distances ascend
        np.testing.assert_array_equal(np.sort(t.visit_near.numpy()[s]),
                                      t.visit_near.numpy()[s])
    assert int(j.total) > 0


@pytest.mark.parametrize("scene,kind", CASES)
def test_closest_hit_packed_matches_jax(tables, traversals, scene, kind):
    _, jt, tt = tables[scene]
    (j_t, j_slot, j_hit, j_plan), (t_t, t_slot, t_hit, t_plan) = \
        traversals[scene, kind, False]
    j_t, hit = np.asarray(j_t), np.asarray(j_hit)
    np.testing.assert_array_equal(t_hit.numpy(), hit)
    assert hit.mean() > 0.1
    np.testing.assert_allclose(t_t.numpy()[hit], j_t[hit], rtol=1e-5)
    j_id = np.asarray(jt.order)[np.asarray(j_slot)]
    t_id = tt.order.numpy()[t_slot.numpy()]
    # a tie: another triangle of the ray's hit list within the tolerance
    o, d, tmax = _rays(kind, 1)
    t_all, _, _ = j_prim.ray_triangle(*map(jnp.asarray, (o, d)),
                                      *map(jnp.asarray, tables[scene][0]),
                                      1e-3, jnp.asarray(tmax)[:, None])
    t_all = np.asarray(t_all)
    with np.errstate(invalid="ignore"):      # inf - inf off the hits
        near = np.abs(t_all - j_t[:, None]) <= 1e-5 * np.abs(j_t[:, None])
    tied = near.sum(1) > 1
    assert (t_id == j_id)[hit & ~tied].all()
    np.testing.assert_array_equal(t_plan.actual.numpy(),
                                  np.asarray(j_plan.actual))


@pytest.mark.parametrize("scene,kind", CASES)
def test_closest_hit_packed_any_hit_matches_jax(tables, traversals, scene,
                                                kind):
    v, _, tt = tables[scene]
    (_, _, j_hit, _), (t_t, t_slot, t_hit, _) = traversals[scene, kind, True]
    hit = np.asarray(j_hit)
    np.testing.assert_array_equal(t_hit.numpy(), hit)
    o, d, tmax = _rays(kind, 1)
    t_all, _, _ = j_prim.ray_triangle(*map(jnp.asarray, (o, d, *v)), 1e-3,
                                      jnp.asarray(tmax)[:, None])
    tri = tt.order.numpy()[t_slot.numpy()][hit]
    tk = t_t.numpy()[hit]
    assert ((tk > 1e-3) & (tk < tmax[hit])).all()
    np.testing.assert_allclose(tk, np.asarray(t_all)[hit][
        np.arange(tri.shape[0]), tri], rtol=1e-5)


def test_any_hit_plan_stops_early_on_occluders(tables, traversals):
    """Rays into 8 stacked layers: the walk stops after the first layers,
    and any hit stops no later than closest hit (both packages)."""
    (j_c, t_c), (j_a, t_a) = (traversals["layers", "layers", m]
                              for m in (False, True))
    bs, near = t_c[3].block_start.numpy(), t_c[3].visit_near.numpy()
    for b in range(bs.shape[0] - 1):    # no ties: the visit order is fixed
        assert np.unique(near[bs[b]:bs[b + 1]]).size == bs[b + 1] - bs[b]
    total = int(t_c[3].total)
    assert t_c[3].actual.sum() < total
    assert (t_a[3].actual <= t_c[3].actual).all()
    np.testing.assert_array_equal(t_a[3].actual.numpy(),
                                  np.asarray(j_a[3].actual))


def test_visit_overflow_flag_matches_jax(tables):
    _, jt, tt = tables["soup"]
    o, d, tmax = _rays("beam", 3)
    j = j_tk.closest_hit_packed(jt, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                1e4, rb=128, max_visits=2, interpret=True)
    t = t_tk.closest_hit_packed(tt, _t(o), _t(d), 1e-3, 1e4, rb=128,
                                max_visits=2)
    assert bool(t[3].overflow) and bool(j[3].overflow)
    np.testing.assert_array_equal(t[3].block_start.numpy(),
                                  np.asarray(j[3].block_start))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("scene,kind", CASES)
def test_block_cull_plain_matches_jax(tables, traversals, scene, kind,
                                      any_hit):
    """With cull_rays = rb the plain version culls per block, as the TPU
    kernel does: slots, hit masks and executed visits equal `gsrt`'s
    exactly; t to rtol 1e-5 (XLA rounds Möller–Trumbore's sums in another
    order)."""
    _, _, tt = tables[scene]
    j_t, j_slot, j_hit, j_plan = traversals[scene, kind, any_hit][0]
    o, d, tmax = _rays(kind, 1)
    t, slot, hit, plan = t_tk.closest_hit_packed_plain(
        tt, _t(o), _t(d), 1e-3, _t(tmax), rb=128, any_hit=any_hit,
        cull_rays=128)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(j_hit))
    np.testing.assert_array_equal(plan.actual.numpy(),
                                  np.asarray(j_plan.actual))
    h = hit.numpy()
    np.testing.assert_allclose(t.numpy()[h], np.asarray(j_t)[h], rtol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_warp_cull_tests_fewer_pairs(tables, any_hit):
    """The scatter rays in the layered scene: culling per 32 rays tests
    fewer (ray, cluster) pairs than culling per block of 128 and finds the
    same hits (closest hit: the same t, slots and visits; any hit, where
    a ray takes any hit: the same mask and visits, each t a hit of its
    slot's triangle)."""
    _, _, tt = tables["layers"]
    o, d, tmax = _rays("scatter", 1)
    out, stats = {}, {}
    for g in (32, 128):
        stats[g] = {}
        out[g] = t_tk.closest_hit_packed_plain(
            tt, _t(o), _t(d), 1e-3, _t(tmax), rb=128, any_hit=any_hit,
            stats=stats[g], cull_rays=g)
    assert stats[32]["group_clusters_tested"] * 32 < \
        stats[128]["group_clusters_tested"] * 128
    (t32, s32, h32, p32), (t128, s128, h128, p128) = out[32], out[128]
    assert torch.equal(h32, h128) and h32.float().mean() > 0.3
    assert torch.equal(p32.actual, p128.actual)
    if not any_hit:
        assert torch.equal(t32, t128) and torch.equal(s32, s128)
        return
    rays = torch.stack([*_t(o).T, *_t(d).T, torch.full((o.shape[0],), 1e-3),
                        _t(tmax)])[:, :, None, None]
    s = s32.long()
    tri = tt.table[s // t_tk.K, :, s % t_tk.K][:, None, :, None]
    t_re = t_tk._mt(*rays, tri)[:, 0, 0]
    assert torch.equal(t_re[h32], t32[h32])
