"""gsrt_torch's cylinders and Mandelbulbs (`ops.primitives`), the chunked
primitive sweeps of `models.path_tracer._closest_hit` and the catalog's
scenes (`scene.primitives_catalog`), held against the JAX package on the
CPU.

Tolerances: the cylinder test, its normal and the distance estimate at
rtol = atol = 1e-5 (f32 reassociation and libm rounding between XLA and
PyTorch), the Mandelbulb's central-difference normal at atol 1e-3. The
Mandelbulb march amplifies the estimate's last-ulp
differences over 96 steps, so at silhouettes a ray may hit in one package
and miss in the other: on a 4,096-ray fan through and around a bulb, hit
and miss agree on at least 99% of rays and t to rtol 1e-4 where both
hit; rays that start inside a bulb's bound, where the march is chaotic,
hold t to atol 1e-5 on 99% of them. The catalog's scenes are bit-equal (the same NumPy draws). A sweep in
chunks equals the unchunked one bit for bit, ties included. The PT
renders (48×32, one sample, 3 bounces) run the JAX package op by op with
its draws, camera rays and scatter norm patched in
(tests/test_torch_pathtracer.py, `jax_camera_rays`, `jax_batch_norm`: the
common grid holds fuzzy metal and glass) and hold the soup rule: at least 99.5% of pixels within atol 1e-4, the mean colour within
2e-3.
"""

from __future__ import annotations

import contextlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import path_tracer as j_pt
from gsrt.ops import primitives as j_prim
from gsrt.scene import primitives_catalog as j_cat

from gsrt_torch import RenderConfig
from gsrt_torch.interop import scene_from_numpy
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import primitives as t_prim
from gsrt_torch.scene import primitives_catalog as t_cat

from test_torch_pathtracer import (_camera, _fields, _pt_draws,
                                   jax_batch_norm)

TOL = dict(rtol=1e-5, atol=1e-5)
J, T = jnp.asarray, torch.as_tensor


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) - o
    d[: n // 2] = aim[: n // 2]                  # half aimed at the shapes
    return o, d


def _cylinders(seed=1, n=24):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.6, n).astype(np.float32)
    h = rng.uniform(0.1, 0.8, n).astype(np.float32)
    return c, r, h


def test_ray_cylinder_and_normal_match_jax():
    o, d = _rays(600, 2)
    c, r, h = _cylinders()
    tmin = np.random.default_rng(3).uniform(0, 0.5, (600, 1)).astype(
        np.float32)
    want = np.asarray(j_prim.ray_cylinder(J(o), J(d), J(c), J(r), J(h),
                                          J(tmin), 1e4))
    got = t_prim.ray_cylinder(T(o), T(d), T(c), T(r), T(h), T(tmin),
                              1e4).numpy()
    hit = np.isfinite(want)
    assert hit.mean() > 0.01
    np.testing.assert_array_equal(np.isfinite(got), hit)
    np.testing.assert_allclose(got[hit], want[hit], **TOL)
    # normals at the nearest hit, on the side and on the caps
    ri, ci = np.nonzero(hit)
    p = o[ri] + want[ri, ci][:, None] * d[ri]
    jn = j_prim.cylinder_normal(J(p), J(c[ci]), J(r[ci]), J(h[ci]))
    tn = t_prim.cylinder_normal(T(p), T(c[ci]), T(r[ci]), T(h[ci]))
    on_cap = np.abs(np.abs(p[:, 1] - c[ci, 1]) - h[ci]) <= 1e-4 * h[ci]
    assert 0 < on_cap.mean() < 1
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)


def test_mandelbulb_de_and_normal_match_jax():
    rng = np.random.default_rng(4)
    p = rng.uniform(-1.4, 1.4, (3000, 3)).astype(np.float32)
    want = np.asarray(j_prim.mandelbulb_de(J(p)))
    got = t_prim.mandelbulb_de(T(p)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert (want > 0).mean() > 0.2 and np.ptp(want) > 0.1
    # central differences 2e-3 apart turn the estimate's ~1e-7
    # differences into ~1e-4 in the normal
    np.testing.assert_allclose(t_prim.mandelbulb_normal(T(p)).numpy(),
                               np.asarray(j_prim.mandelbulb_normal(J(p))),
                               atol=1e-3)


def test_ray_mandelbulb_matches_jax_by_share():
    """A 64×64 fan from (0, 0.3, 3.2) through and around a bulb of radius
    1.25 and a smaller one: hit and miss equal on at least 99% of rays, t
    to rtol 1e-4 where both hit. 512 rays from inside the first bulb's
    bound start marching at t_min, where the estimate is near 0 and its
    steps chaotic, and most hit within 1e-2 of it: hit and miss equal on
    99% of them and t to atol 1e-5 on 99% of those both hit."""
    ys, xs = np.mgrid[-1:1:64j, -1:1:64j].astype(np.float32)
    d = np.stack([xs, ys, -np.full_like(xs, 1.6)], -1).reshape(-1, 3)
    o = np.tile(np.float32([0.0, 0.3, 3.2]), (d.shape[0], 1))
    d_in = np.random.default_rng(9).normal(size=(512, 3)).astype(np.float32)
    o_in = np.tile(np.float32([0.2, 0.1, 0.9]), (512, 1))
    centers = np.float32([[0, 0, 0], [0.9, -0.8, -0.5]])
    radii = np.float32([1.25, 0.5])
    for orig, dirn in ((o, d), (o_in, d_in)):
        want = np.asarray(j_prim.ray_mandelbulb(J(orig), J(dirn), J(centers),
                                                J(radii), 1e-3, 1e4))
        got = t_prim.ray_mandelbulb(T(orig), T(dirn), T(centers), T(radii),
                                    1e-3, 1e4).numpy()
        hw, hg = np.isfinite(want), np.isfinite(got)
        assert hw[:, 0].mean() > 0.2 and not hw.all()
        assert (hw == hg).mean() >= 0.99
        both = hw & hg
        if orig is o:
            np.testing.assert_allclose(got[both], want[both], rtol=1e-4)
        else:
            assert (np.abs(got - want)[both] <= 1e-5).mean() >= 0.99


FACTORIES = {
    "rtiow": ("ray_tracing_in_one_weekend", {}),
    "planets": ("planets_in_one_weekend", {}),
    "cubes": ("cube_and_spheres", {}),
    "cubesgrid": ("cubes_and_common_scene", dict(grid=6)),
    "cylinders": ("cylinder_cubes_common_scene", dict(grid=6)),
    "mandelbulb": ("mandelbulb_scene", {}),
    "simple": ("simple_test", {}),
}


@pytest.mark.parametrize("name", list(FACTORIES))
def test_catalog_scene_matches_jax(name):
    fn, kw = FACTORIES[name]
    js, jcam, jopts = getattr(j_cat, fn)(40, 30, **kw)
    ts, tcam, topts = getattr(t_cat, fn)(40, 30, device="cpu", **kw)
    assert topts == jopts
    assert torch.equal(tcam.view, T(np.asarray(jcam.view)))
    assert float(tcam.fy) == float(jcam.fy)
    via = scene_from_numpy(_fields(js), device="cpu")
    for k, a in _fields(js).items():
        if k == "materials":
            for m, v in a.items():
                assert torch.equal(getattr(ts.materials, m), T(v)), m
            continue
        got = getattr(ts, k)
        assert got is not None and got.dtype == getattr(via, k).dtype, k
        assert torch.equal(got, T(a)), k
    for k, v in ts._asdict().items():
        if k not in ("materials", "tri_table", "tri_clusters"):
            assert (v is None) == (getattr(js, k) is None), k


def _mixed_scene():
    """Spheres, boxes, cylinders and triangles, each set with a duplicate
    of its first member, so the sweeps meet exact ties."""
    b = t_cat._SceneBuilder()
    rng = np.random.default_rng(5)
    m = [b.lambertian((0.6, 0.3, 0.2)), b.metallic((0.8, 0.8, 0.8), 0.1),
         b.dielectric(1.5)]
    for k in range(40):
        c = rng.uniform(-2, 2, 3)
        b.sphere(c, float(rng.uniform(0.1, 0.4)), m[k % 3])
        b.box(c + 0.5, c + 0.5 + rng.uniform(0.1, 0.5, 3), m[(k + 1) % 3])
        b.cylinder(c - 0.5, float(rng.uniform(0.1, 0.3)), m[k % 2],
                   half_h=float(rng.uniform(0.1, 0.4)))
        b.tri(c, c + rng.normal(0, 0.4, 3), c + rng.normal(0, 0.4, 3),
              m[k % 3])
    b.sph.append(b.sph[0])
    b.boxes.append(b.boxes[0])
    b.cyls.append(b.cyls[0])
    b.tris.append(b.tris[0])
    return b.build("cpu")


def test_chunked_sweep_equals_unchunked(monkeypatch):
    scene = _mixed_scene()
    o, d = _rays(700, 6)
    want = t_pt._closest_hit(scene, T(o), T(d), 1e-3, 1e4)
    monkeypatch.setattr(t_pt, "SWEEP_PAIRS", 700 * 3)      # 3 a chunk
    got = t_pt._closest_hit(scene, T(o), T(d), 1e-3, 1e4)
    assert want[3].float().mean() > 0.3
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)


def test_closest_hit_with_cylinders_and_bulbs_matches_jax():
    """Cylinders and a Mandelbulb beside spheres: t, normals and
    materials on 600 rays, hit and miss on at least 99% of them."""
    b = j_cat._SceneBuilder()
    c, r, h = _cylinders(7, 10)
    for k in range(10):
        b.cylinder(tuple(c[k]), float(r[k]), b.lambertian((0.5, 0.2, 0.1)),
                   half_h=float(h[k]))
    b.sphere((0.0, -0.5, -1.5), 0.4, b.metallic((0.9, 0.9, 0.9), 0.0))
    b.mandelbulb((0.3, 0.4, 0.2), 0.9, b.lambertian((0.5, 0.7, 1.0)))
    js = b.build()
    ts = scene_from_numpy(_fields(js), device="cpu")
    o, d = _rays(600, 8)
    jt, jn, jm, jh, _, _ = j_pt._closest_hit(js, J(o), J(d), 1e-3, 1e4)
    tt, tn, tm, th, _, _ = t_pt._closest_hit(ts, T(o), T(d), 1e-3, 1e4)
    jh, th = np.asarray(jh), th.numpy()
    assert (jh == th).mean() >= 0.99 and jh.mean() > 0.3
    # rays whose hit lies on the same primitive in both packages
    same = jh & th & (np.asarray(jm) == tm.numpy())
    assert same.mean() >= 0.97 * jh.mean()
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(jt)[same],
                               rtol=1e-4)
    cyl = same & (np.asarray(jm) < 10)              # materials 0-9
    assert cyl.sum() > 20
    np.testing.assert_allclose(tn.numpy()[cyl], np.asarray(jn)[cyl], **TOL)


@contextlib.contextmanager
def jax_camera_rays(jcam, jcfg, seed, samples):
    """The port's camera rays replaced by the JAX package's for the same
    keys (after the port has taken its jitter draw, so the draw order
    holds). The two packages' camera-to-world inverses differ in the last
    place (`test_camera_rays_and_sky_match_jax` holds them to 1e-5), and
    the RTIOW ground sphere's quadratic (radius 1000) turns 2e-7 in an
    origin into 1e-3 in t."""
    rays = []
    for k in jax.random.split(jax.random.PRNGKey(seed), samples):
        with jax.disable_jit():
            rays.append(j_pt.generate_camera_rays(jax.random.split(k)[0],
                                                  jcam, jcfg))
    orig_fn = t_pt.generate_camera_rays

    def replaced(*a, **kw):
        orig_fn(*a, **kw)
        o, d = rays.pop(0)
        return T(np.asarray(o)), T(np.asarray(d))
    with mock.patch.object(t_pt, "generate_camera_rays", replaced):
        yield
    assert not rays


def _render_pair(name, kw):
    fn = getattr(j_cat, FACTORIES[name][0])
    js, jcam, opts = fn(48, 32, **kw)
    ts = scene_from_numpy(_fields(js), device="cpu")
    cfg = dict(width=48, height=32, samples=1, bounces=3,
               has_sky=opts["has_sky"], gamma_correction=False)
    with jax.disable_jit():
        want = np.asarray(j_pt.render_path_traced(js, jcam, JCfg(**cfg),
                                                  seed=0, interpret=True))
    draws, _ = _pt_draws(0, 1, 3, 48 * 32)
    with draws.patch(), jax_camera_rays(jcam, JCfg(**cfg), 0, 1), \
            jax_batch_norm():
        got = t_pt.render_path_traced(ts, _camera(jcam), RenderConfig(**cfg),
                                      seed=0)
    assert draws.done()
    return got.numpy(), want


@pytest.mark.parametrize("name,kw", [("cylinders", dict(grid=3)),
                                     ("mandelbulb", {})])
def test_render_matches_jax(name, kw):
    got, want = _render_pair(name, kw)
    assert np.isfinite(got).all() and got.std() > 0.05
    near = (np.abs(got - want) <= 1e-4).all(-1)
    assert near.mean() >= 0.995
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)),
                               atol=2e-3)
