"""gsrt_torch's Morton-cluster bundle traversal (`ops.clusters`:
`build_tri_clusters`, `traverse_clusters`, `closest_hit_tri_clusters`;
`models.path_tracer.with_tri_clusters` and its branch of `_closest_hit`),
held against the JAX package and against the port's own brute-force
sweep on the CPU.

Tolerances: the clusters bit-equal; t at rtol 1e-5 against the JAX
package, (cluster, k) equal where no other triangle lies within that of
t, hit equal, and the whole-bundle counters (AABB tests, clusters
intersected) equal, since both walk the same branches; against the
port's brute-force sweep t bit-equal (the same Möller–Trumbore on the
same vertices).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.models import path_tracer as j_pt
from gsrt.ops import clusters as j_cl

from gsrt_torch.interop import scene_from_numpy
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import clusters as t_cl
from gsrt_torch.ops import primitives as t_prim

J, T = jnp.asarray, torch.as_tensor


def _tris(n, seed=0, spread=6.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    uv = [rng.random((n, 2)).astype(np.float32) for _ in range(3)]
    return c, c + e1, c + e2, (np.arange(n) % 5).astype(np.int32), uv


def _rays(R, seed=1):
    """Half a coherent bundle from one point, half scattered."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-12, 12, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    o[: R // 2] = np.float32([0.5, 1.0, -14.0])
    d[: R // 2] = np.float32([0, 0, 1]) + 0.35 * d[: R // 2]
    return o, d


@pytest.fixture(scope="module")
def built():
    v0, v1, v2, mat, uv = _tris(900)
    jtc = j_cl.build_tri_clusters(*map(J, (v0, v1, v2, mat)), *map(J, uv),
                                  k=32, sup=4)
    ttc = t_cl.build_tri_clusters(*map(T, (v0, v1, v2, mat)), *map(T, uv),
                                  k=32, sup=4)
    return (v0, v1, v2), jtc, ttc


def test_build_tri_clusters_matches_jax(built):
    _, jtc, ttc = built
    for k in ("v0", "v1", "v2", "mat", "uv0", "uv1", "uv2"):
        assert torch.equal(getattr(ttc, k), T(np.asarray(getattr(jtc, k)))), k
    for k in ("cl_min", "cl_max", "sup_min", "sup_max", "valid"):
        assert torch.equal(getattr(ttc.clusters, k),
                           T(np.asarray(getattr(jtc.clusters, k)))), k
    assert ttc.clusters.sup == jtc.clusters.sup == 4


@pytest.mark.parametrize("window", ["scalar", "per-ray"])
def test_closest_hit_matches_jax_and_the_sweep(built, window):
    verts, jtc, ttc = built
    o, d = _rays(640)
    rng = np.random.default_rng(2)
    if window == "scalar":
        tmin, tmax = 1e-3, 1e4
    else:   # [R, 1] windows, some range-limited as shadow and AO rays are
        tmin = rng.uniform(0, 2, (640, 1)).astype(np.float32)
        tmax = rng.uniform(3, 30, (640, 1)).astype(np.float32)
    want = j_cl.closest_hit_tri_clusters(jtc, J(o), J(d), J(tmin), J(tmax))
    got = t_cl.closest_hit_tri_clusters(ttc, T(o), T(d), T(tmin), T(tmax))
    jt, jc, jk, jh, j_aabb, j_leaf = (np.asarray(a) for a in want)
    tt, tc, tk, th = (a.numpy() for a in got[:4])
    np.testing.assert_array_equal(th, jh)
    assert 0.2 < jh.mean() < 0.95
    np.testing.assert_allclose(tt[jh], jt[jh], rtol=1e-5)
    assert (got[4], got[5]) == (int(j_aabb), int(j_leaf))
    assert got[5] < ttc.clusters.m * 640          # the bundle skipped work
    # (cluster, k) where no second triangle lies within 1e-5 of the hit
    v = [T(a) for a in verts]
    t_all = t_prim.ray_triangle(T(o), T(d), *v, T(tmin), T(tmax))[0]
    t_all = t_all.numpy()
    close = (np.abs(t_all - tt[:, None]) <= 1e-5 * np.abs(tt[:, None]))
    untied = jh & (close.sum(1) == 1)
    assert untied.mean() > 0.9 * jh.mean()
    np.testing.assert_array_equal(tc[untied], jc[untied])
    np.testing.assert_array_equal(tk[untied], jk[untied])
    # the port's brute-force sweep: t bit for bit
    np.testing.assert_array_equal(tt, t_all.min(1))


def test_coherent_bundle_skips_clusters():
    v0, v1, v2, mat, _ = _tris(2000, seed=5, spread=50.0)
    tc = t_cl.build_tri_clusters(*map(T, (v0, v1, v2, mat)), k=64, sup=8)
    o = torch.tensor([[200.0, 0, 0]]).expand(64, 3)
    d = torch.tensor([[-1.0, 0, 0]]).expand(64, 3)
    *_, aabb_n, leaf_n = t_cl.closest_hit_tri_clusters(tc, o, d, 1e-3, 1e4)
    assert leaf_n < 64 * tc.clusters.m // 2
    assert aabb_n >= 64 * tc.clusters.sup_min.shape[0]


def test_closest_hit_branch_matches_jax():
    """`_closest_hit` over a textured triangle scene with tri-clusters
    attached: t, normal, material and texcoords against the JAX
    package's, and its clusters win over the brute-force sweep only by
    branch order (tri_table first, then tri_clusters)."""
    v0, v1, v2, mat, uv = _tris(600, seed=6)
    z3, z = np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
    fields = dict(sph_center=z3, sph_radius=z, sph_mat=z.astype(np.int32),
                  box_min=z3, box_max=z3, box_mat=z.astype(np.int32),
                  tri_v0=v0, tri_v1=v1, tri_v2=v2, tri_mat=mat,
                  tri_uv0=uv[0], tri_uv1=uv[1], tri_uv2=uv[2],
                  materials=dict(model=np.zeros(5, np.int32),
                                 diffuse=np.full((5, 3), 0.5, np.float32),
                                 fuzziness=np.zeros(5, np.float32),
                                 refraction_index=np.ones(5, np.float32)))
    ts = scene_from_numpy(fields, device="cpu")
    js = j_pt.PrimitiveScene(**{k: J(v) for k, v in fields.items()
                                if k != "materials"},
                             materials=j_pt.Materials(
                                 **{k: J(v) for k, v in
                                    fields["materials"].items()}))
    jsc = j_pt.with_tri_clusters(js, k=32, sup=4)
    tsc = t_pt.with_tri_clusters(ts, k=32, sup=4)
    assert tsc.tri_clusters is not None
    assert t_pt.with_tri_clusters(ts).tri_clusters is not None
    assert t_pt.with_tri_clusters(ts, k=400).tri_clusters is None
    o, d = _rays(512, seed=7)
    jt, jn, jm, jh, juv, _ = j_pt._closest_hit(jsc, J(o), J(d), 1e-3, 1e4)
    tt, tn, tm, th, tuv, _ = t_pt._closest_hit(tsc, T(o), T(d), 1e-3, 1e4)
    jh = np.asarray(jh)
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_allclose(tt.numpy()[jh], np.asarray(jt)[jh], rtol=1e-5)
    same = jh & (tm.numpy() == np.asarray(jm))
    assert same.mean() >= 0.99 * jh.mean()
    np.testing.assert_allclose(tn.numpy()[same], np.asarray(jn)[same],
                               atol=1e-5)
    np.testing.assert_allclose(tuv.numpy()[same], np.asarray(juv)[same],
                               atol=1e-4)
    brute = t_pt._closest_hit(ts, T(o), T(d), 1e-3, 1e4)
    assert torch.equal(brute[0], tt)
