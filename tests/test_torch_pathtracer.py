"""gsrt_torch's path tracer (`models.path_tracer`), its primitive tests
(`ops.primitives`), the Cornell box (`scene.primitives_catalog`) and
`interop.scene_from_numpy`, held against the JAX package on the same
scenes (CPU; the JAX package's cast and traversal kernels in interpret
mode, the port's through their plain versions).

The two packages draw different random numbers for one seed (jax.random
against torch.Generator), so the render comparisons patch, in this file
only, the port's draw helpers (`_uniform`, `_random_unit`,
`_random_in_unit_disk`) to hand back the arrays the JAX package drew for
the same keys, in the order the port asks for them.

Tolerances: Cornell box arrays and coherence permutations exactly;
primitive hit distances, normals and scatter directions at rtol = atol =
1e-5 (f32 reassociation and FMA contraction between XLA and PyTorch);
renders at atol 1e-4 outside pixels whose binned primary triangle differs
between the packages (a last-ulp difference in t can pick the other
triangle of a near tie; at most 0.2% of pixels may). The path-traced
renders (one sample; the Cornell box's bounce 0 through the brute-force
sweep) run the JAX package op by op (`jax.disable_jit`), where XLA rounds
each operation on its own as PyTorch does; under jit it fuses and
contracts the bounce arithmetic and about 1% of the soup's paths diverge.
Op by op the Cornell box holds every pixel to atol 1e-4. The soup holds at
least 99.5% of its pixels to atol 1e-4 and its mean colour to 2e-3: a
last-ulp difference in a hit point off its metal floor or glass sphere
still flips a scatter decision on about 0.2% of its paths (3 of 1536
pixels). The port's binned primary against its own block traversal at
atol 1e-4, as the JAX package holds its own.
"""

from __future__ import annotations

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsrt.core.config import RenderConfig as JCfg
from gsrt.core import types as j_types
from gsrt.models import path_tracer as j_pt
from gsrt.ops import primitives as j_prim
from gsrt.ops import tri_binning as j_tbin
from gsrt.scene import primitives_catalog as j_cat

from gsrt_torch import RenderConfig
from gsrt_torch.interop import camera_from_numpy, scene_from_numpy
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import primitives as t_prim
from gsrt_torch.ops import tri_binning as t_tbin
from gsrt_torch.scene import primitives_catalog as t_cat

TOL = dict(rtol=1e-5, atol=1e-5)
W, H = 48, 32
KW = dict(width=W, height=H, samples=2, bounces=3, gamma_correction=False,
          tile_w=16, tile_h=8)
PAIRS = 1 << 14
LIGHT = (0.0, -4.0, -4.0)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _fields(scene) -> dict:
    """A JAX PrimitiveScene's arrays as NumPy, as scene_from_numpy takes
    them."""
    f = {k: np.asarray(v) for k, v in scene._asdict().items()
         if v is not None and k not in ("materials", "tri_table",
                                        "tri_clusters")}
    f["materials"] = {k: np.asarray(v) for k, v in
                      scene.materials._asdict().items() if v is not None}
    return f


def _camera(jcam):
    return camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                             np.asarray(jcam.fy), np.asarray(jcam.cx),
                             np.asarray(jcam.cy), jcam.width, jcam.height,
                             device="cpu")


def _soup_scene(n=300, seed=3):
    """300 random triangles over a metal floor, with a glass sphere and a
    box: every material model, every primitive type and (past 256
    triangles) the packed-cluster traversal."""
    rng = np.random.default_rng(seed)
    b = j_cat._SceneBuilder()
    mats = [b.lambertian((0.7, 0.5, 0.3)), b.lambertian((0.2, 0.6, 0.8)),
            b.light((4.0, 4.0, 4.0)), b.metallic((0.9, 0.9, 0.9), 0.2)]
    glass = b.dielectric(1.5)
    b.quad((-5, 1.5, 6), (5, 1.5, 6), (5, 1.5, -3), (-5, 1.5, -3), mats[3])
    c = rng.uniform(-1.5, 1.5, (n, 3))
    for i in range(n):
        a = c[i] + rng.normal(0, 0.3, 3)
        d = c[i] + rng.normal(0, 0.3, 3)
        b.tri(tuple(c[i]), tuple(a), tuple(d), mats[i % 3])
    b.sphere((1.8, 0.6, -1.5), 0.5, glass)
    b.box((-2.6, 0.6, -1.8), (-1.8, 1.4, -1.0), mats[0])
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    """{name: (JAX scene, port scene, JAX camera, port camera)}."""
    js = j_pt.with_tri_table(_soup_scene())
    ts = t_pt.with_tri_table(scene_from_numpy(_fields(_soup_scene()),
                                              device="cpu"))
    jcam = j_types.make_camera(j_types.look_at((0, -0.5, -5.0), (0, 0, 0.0)),
                               55.0, W, H)
    jbox, jbcam, _ = j_cat.cornell_box(W, H)
    tbox, tbcam, _ = t_cat.cornell_box(W, H, device="cpu")
    return {"soup": (js, ts, jcam, _camera(jcam)),
            "cornell": (jbox, tbox, jbcam, tbcam)}


class JaxDraws:
    """Stands in for the port's draw helpers, handing back the JAX
    package's draws in order."""

    def __init__(self):
        self.uniform, self.unit = [], []

    def _next(self, queue, shape):
        a = np.asarray(queue.pop(0))
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.as_tensor(a.copy())

    def patch(self):
        return mock.patch.multiple(
            t_pt, _uniform=lambda gen, shape: self._next(self.uniform, shape),
            _random_unit=lambda gen, shape: self._next(self.unit, shape),
            _random_in_unit_disk=lambda gen, n: torch.zeros((n, 2)))

    def done(self) -> bool:
        return not self.uniform and not self.unit


def _jitter(key, R):
    """generate_camera_rays' pixel jitter for `key`."""
    return jax.random.uniform(jax.random.split(key)[0], (R, 2))


def _pt_draws(seed, samples, bounces, R):
    d = JaxDraws()
    jitters = []
    for k in jax.random.split(jax.random.PRNGKey(seed), samples):
        kr, key = jax.random.split(k)
        jitters.append(_jitter(kr, R))
        d.uniform.append(jitters[-1])
        for _ in range(bounces):
            key, ks = jax.random.split(key)
            q1, q2, _ = jax.random.split(ks, 3)
            d.unit.append(j_pt._random_unit(q1, (R, 3)))
            d.uniform.append(jax.random.uniform(q2, (R,)))
    return d, jitters


def _occlusion_draws(seed, rays, R):
    key = jax.random.PRNGKey(seed)
    d = JaxDraws()
    d.uniform.append(_jitter(key, R))
    for s in range(rays):
        d.unit.append(j_pt._random_unit(jax.random.fold_in(key, s + 1),
                                        (R, 3)))
    return d, [d.uniform[0]]


def _primary_id_mismatch(scene_pair, cam_pair, jitters, cfg):
    """Pixels whose binned primary triangle differs between the packages,
    over every sample's camera rays."""
    js, ts, jcam, tcam = scene_pair + cam_pair
    kw = dict(tile_w=cfg.tile_w, tile_h=cfg.tile_h, max_pairs=PAIRS)
    jb = j_tbin.build_tri_binning(js.tri_v0, js.tri_v1, js.tri_v2, jcam,
                                  **kw)
    tb = t_tbin.build_tri_binning(ts.tri_v0, ts.tri_v1, ts.tri_v2, tcam,
                                  **kw)
    bad = np.zeros((H, W), bool)
    cast_kw = dict(width=W, height=H, tile_w=cfg.tile_w, tile_h=cfg.tile_h)
    for jit in jitters:
        d = JaxDraws()
        d.uniform.append(jit)
        with d.patch():
            _, dirn = t_pt.generate_camera_rays(None, tcam, cfg)
        _, j_id = j_tbin.cast_primary(jb, jnp.asarray(dirn.numpy()),
                                      jcam.position, interpret=True,
                                      **cast_kw)
        _, t_id = t_tbin.cast_primary(tb, dirn, tcam.position, **cast_kw)
        bad |= np.asarray(j_id) != t_id.numpy()
    return bad


RENDERS = {
    "PT": (lambda pt, s, c, cfg, **kw: pt.render_path_traced(
        s, c, cfg, seed=0, tri_max_pairs=PAIRS, **kw),
        lambda cfg: _pt_draws(0, cfg["samples"], cfg["bounces"], W * H)),
    "SH": (lambda pt, s, c, cfg, **kw: pt.render_shadow_rays(
        s, c, cfg, light_pos=LIGHT, tri_max_pairs=PAIRS, **kw),
        lambda cfg: _occlusion_draws(0, 2, W * H)),
    "AO": (lambda pt, s, c, cfg, **kw: pt.render_ambient_occlusion(
        s, c, cfg, tri_max_pairs=PAIRS, **kw),
        lambda cfg: _occlusion_draws(0, 4, W * H)),
}


@pytest.mark.parametrize("render", list(RENDERS))
@pytest.mark.parametrize("scene", ["soup", "cornell"])
def test_render_matches_jax(scenes, scene, render):
    js, ts, jcam, tcam = scenes[scene]
    call, draws = RENDERS[render]
    op_by_op = render == "PT"
    # op by op is slow: one sample; the Cornell box's bounce 0 through the
    # brute-force sweep
    kw = dict(KW, samples=1) if op_by_op else KW
    impl = "block" if (scene, render) == ("cornell", "PT") else "auto"
    with jax.disable_jit(op_by_op):
        want = np.asarray(call(j_pt, js, jcam, JCfg(**kw), interpret=True,
                               primary_impl=impl))
    d, jitters = draws(kw)
    cfg = RenderConfig(**kw)
    with d.patch():
        got, flags = call(t_pt, ts, tcam, cfg, return_flags=True,
                          primary_impl=impl)
    assert d.done()
    assert not any(bool(v) for v in flags.values())
    assert got.shape == (H, W, 3) and torch.isfinite(got).all()
    bad = _primary_id_mismatch((js, ts), (jcam, tcam), jitters, cfg)
    assert bad.mean() <= 0.002
    got = got.numpy()
    if (scene, render) == ("soup", "PT"):
        near = (np.abs(got - want) <= 1e-4).all(-1)
        assert near[~bad].mean() >= 0.995
        np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)),
                                   atol=2e-3)
    else:
        np.testing.assert_allclose(got[~bad], want[~bad], atol=1e-4, rtol=0)
    assert got.std() > 0.05


@pytest.mark.parametrize("render", list(RENDERS))
def test_binned_primary_matches_block(scenes, render):
    """The port against itself: bounce 0 through the binned cast or
    through the traversal, with one generator's draws."""
    _, ts, _, tcam = scenes["soup"]
    call, _ = RENDERS[render]
    cfg = RenderConfig(**KW)
    binned = call(t_pt, ts, tcam, cfg, primary_impl="binned")
    block = call(t_pt, ts, tcam, cfg, primary_impl="block")
    np.testing.assert_allclose(binned.numpy(), block.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_calibrated_grows_the_pair_buffer(scenes):
    _, ts, _, tcam = scenes["soup"]
    cfg = RenderConfig(**KW)
    img, info = t_pt.render_path_traced_calibrated(ts, tcam, cfg,
                                                   tri_max_pairs=256)
    assert info["retries"] >= 1 and info["tri_max_pairs"] > 256
    assert not info["flags"]["binned_pairs_overflow"]
    want = t_pt.render_path_traced(ts, tcam, cfg,
                                   tri_max_pairs=info["tri_max_pairs"])
    assert torch.equal(img, want)


def _rays(n, seed, spread=2.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    o[: n // 2] = np.float32([0, -0.5, -5.0])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = np.float32([0, 0, 1]) + 0.3 * d[: n // 2]
    return o, d


@pytest.mark.parametrize("scene", ["soup", "cornell"])
def test_closest_hit_matches_jax(scenes, scene):
    """Spheres, boxes and triangles (the table traversal on the soup, the
    brute-force sweep in the Cornell box) on mixed rays."""
    js, ts, jcam, _ = scenes[scene]
    o, d = _rays(512, 5)
    if scene == "cornell":
        o = o * 100 + np.float32([278, 278, -278])
    tmax = np.random.default_rng(6).uniform(1, 2e3, (512, 1)).astype(
        np.float32)
    j = j_pt._closest_hit(js, jnp.asarray(o), jnp.asarray(d), 1e-3,
                          jnp.asarray(tmax))
    t = t_pt._closest_hit(ts, _t(o), _t(d), 1e-3, _t(tmax))
    hit = np.asarray(j[3])
    np.testing.assert_array_equal(t[3].numpy(), hit)
    assert 0.2 < hit.mean()
    np.testing.assert_allclose(t[0].numpy()[hit], np.asarray(j[0])[hit],
                               **TOL)
    np.testing.assert_allclose(t[1].numpy()[hit], np.asarray(j[1])[hit],
                               **TOL)
    np.testing.assert_array_equal(t[2].numpy()[hit], np.asarray(j[2])[hit])
    assert not bool(t[5]) and t[4] is None


@pytest.mark.parametrize("sort", [False, True])
def test_any_hit_matches_jax(scenes, sort):
    js, ts, _, _ = scenes["soup"]
    o, d = _rays(1024, 7)
    rng = np.random.default_rng(8)
    live = rng.random(1024) < 0.7
    tmax = rng.uniform(0.5, 6.0, (1024, 1)).astype(np.float32)
    j_hit, j_ovf = j_pt._any_hit(js, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                 jnp.asarray(tmax), live=jnp.asarray(live),
                                 sort=sort)
    t_hit, t_ovf = t_pt._any_hit(ts, _t(o), _t(d), 1e-3, _t(tmax),
                                 live=_t(live), sort=sort)
    np.testing.assert_array_equal(t_hit.numpy() & live,
                                  np.asarray(j_hit) & live)
    assert (t_hit.numpy() & live).mean() > 0.1
    assert not bool(t_ovf) and not bool(j_ovf)


def test_coherence_perm_matches_jax(scenes):
    js, ts, _, _ = scenes["soup"]
    o, d = _rays(2000, 9)
    live = np.random.default_rng(10).random(2000) < 0.6
    lo, hi, park_o, park_d = j_pt._scene_sort_bounds(js)
    t_lo, t_hi, t_po, t_pd = t_pt._scene_sort_bounds(ts)
    for a, b in ((lo, t_lo), (hi, t_hi), (park_o, t_po), (park_d, t_pd)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    perm, inv = j_pt._coherence_perm(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(live), lo, hi)
    t_perm, t_inv = t_pt._coherence_perm(_t(o), _t(d), _t(live), t_lo, t_hi)
    np.testing.assert_array_equal(t_perm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(t_inv.numpy(), np.asarray(inv))


def test_scatter_matches_jax(scenes):
    """Every material model with the JAX package's draws."""
    js, ts, _, _ = scenes["soup"]
    rng = np.random.default_rng(0)
    R = 4000
    n = rng.normal(size=(R, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    mat = rng.integers(0, 5, R).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want = j_pt._scatter(key, js.materials, jnp.asarray(mat), jnp.asarray(d),
                         jnp.asarray(n), None)
    q1, q2, _ = jax.random.split(key, 3)
    draws = JaxDraws()
    draws.unit.append(j_pt._random_unit(q1, (R, 3)))
    draws.uniform.append(jax.random.uniform(q2, (R,)))
    with draws.patch():
        got = t_pt._scatter(None, ts.materials, _t(mat), _t(d), _t(n))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_camera_rays_and_sky_match_jax(scenes):
    _, _, jcam, tcam = scenes["soup"]
    key = jax.random.PRNGKey(4)
    cfg = RenderConfig(**KW)
    jo, jd = j_pt.generate_camera_rays(key, jcam, JCfg(**KW))
    draws = JaxDraws()
    draws.uniform.append(_jitter(key, W * H))
    with draws.patch():
        to, td = t_pt.generate_camera_rays(None, tcam, cfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(t_pt._sky(td, True).numpy(),
                               np.asarray(j_pt._sky(jd, True)), **TOL)
    assert not t_pt._sky(td, False).any()


def test_primitives_match_jax():
    rng = np.random.default_rng(11)
    o, d = _rays(300, 12)
    c = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.8, 40).astype(np.float32)
    lo = c - r[:, None]
    hi = c + rng.uniform(0.1, 0.8, (40, 3)).astype(np.float32)
    v1 = c + rng.normal(0, 0.5, (40, 3)).astype(np.float32)
    v2 = c + rng.normal(0, 0.5, (40, 3)).astype(np.float32)
    J, T = jnp.asarray, _t
    pairs = [
        (j_prim.ray_sphere(J(o), J(d), J(c), J(r), 1e-3, 1e4),
         t_prim.ray_sphere(T(o), T(d), T(c), T(r), 1e-3, 1e4)),
        (j_prim.ray_box(J(o), J(d), J(lo), J(hi), 1e-3, 1e4),
         t_prim.ray_box(T(o), T(d), T(lo), T(hi), 1e-3, 1e4)),
        (j_prim.ray_triangle(J(o), J(d), J(c), J(v1), J(v2), 1e-3, 1e4)[0],
         t_prim.ray_triangle(T(o), T(d), T(c), T(v1), T(v2), 1e-3, 1e4)[0]),
    ]
    for jt, tt in pairs:
        jt = np.asarray(jt)
        hit = np.isfinite(jt)
        assert hit.any()
        np.testing.assert_array_equal(torch.isfinite(tt).numpy(), hit)
        np.testing.assert_allclose(tt.numpy()[hit], jt[hit], **TOL)
    p = o[:40] + 3 * d[:40]
    for jn, tn in (
            (j_prim.sphere_normal(J(p), J(c)),
             t_prim.sphere_normal(T(p), T(c))),
            (j_prim.box_normal(J(p), J(lo), J(hi)),
             t_prim.box_normal(T(p), T(lo), T(hi))),
            (j_prim.triangle_normal(J(c), J(v1), J(v2)),
             t_prim.triangle_normal(T(c), T(v1), T(v2)))):
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)


def test_cornell_box_and_scene_from_numpy_match_jax(scenes):
    jbox, tbox, jcam, tcam = scenes["cornell"]
    via = scene_from_numpy(_fields(jbox), device="cpu")
    for name, a in _fields(jbox).items():
        if name == "materials":
            for k, v in a.items():
                assert torch.equal(getattr(tbox.materials, k), _t(v)), k
                assert torch.equal(getattr(via.materials, k), _t(v)), k
        else:
            assert torch.equal(getattr(tbox, name), _t(a)), name
            assert torch.equal(getattr(via, name), _t(a)), name
    assert torch.equal(tcam.view, _t(jcam.view))
    assert tbox.tri_v0.dtype == torch.float32
    assert tbox.tri_mat.dtype == torch.int32


def _with_part(scene, part, xp):
    """The Cornell box with one more part, its arrays from NumPy through
    `xp` (jnp.asarray or torch.as_tensor): a white cylinder on the floor,
    a Mandelbulb 3 units before the camera (the estimate is unscaled, so
    it fills the view there), a texture on the white material, the same
    with a cutout mask (half clear), or tri-clusters."""
    f32, i32 = (lambda a: xp(np.float32(a))), (lambda a: xp(np.int32(a)))
    if part == "cyl_center":
        return scene._replace(cyl_center=f32([[150, 100, -150]]),
                              cyl_radius=f32([70]), cyl_half_h=f32([100]),
                              cyl_mat=i32([2]))
    if part == "mnd_center":
        return scene._replace(mnd_center=f32([[278, 278, 797]]),
                              mnd_radius=f32([1.25]), mnd_mat=i32([1]))
    tex = np.random.default_rng(0).random((1, 8, 8, 3))
    mats = scene.materials._replace(texture_id=i32([-1, -1, 0, -1]))
    scene = scene._replace(textures=f32(tex), materials=mats)
    if part == "alpha_textures":
        return scene._replace(alpha_textures=f32(np.tri(8)[None]))
    return scene


@pytest.mark.parametrize("part", ["cyl_center", "mnd_center", "textures",
                                  "alpha_textures", "tri_clusters",
                                  "gaussians"])
def test_unported_parts_raise(scenes, part):
    """Each part that once raised here renders as in the JAX package (the
    name is kept from then): the Cornell box's SH render with a cylinder,
    a Mandelbulb, a texture, a cutout mask or tri-clusters (k=4, sup=2:
    the box has 12 triangles) added, pixels within atol 1e-4 outside
    those whose binned primary triangle differs; with the Mandelbulb,
    whose march may flip hit and miss at its silhouette, 99% of pixels.
    Splats: a cloud of opacity 0 in the box's PT render (op by op, one
    sample, 2 bounces) leaves it as the JAX package renders it, pixels
    within atol 1e-4."""
    jbox, tbox, jcam, tcam = scenes["cornell"]
    if part == "gaussians":
        from gsrt.core.types import GaussianCloud as JCloud
        from gsrt_torch.core.types import GaussianCloud
        kw = dict(KW, samples=1, bounces=2)
        arrays = (np.float32([[278.0, 278.0, -200.0]]),
                  np.float32([[900.0, 0, 0, 900, 0, 900]]),
                  np.zeros(1, np.float32), np.ones((1, 1, 3), np.float32))
        with jax.disable_jit():
            want = np.asarray(j_pt.render_path_traced(
                jbox, jcam, JCfg(**kw), gaussians=JCloud(*map(jnp.asarray,
                                                              arrays)),
                primary_impl="block"))
        d, _ = _pt_draws(0, 1, 2, W * H)
        with d.patch():
            got = t_pt.render_path_traced(
                tbox, tcam, RenderConfig(**kw),
                gaussians=GaussianCloud(*map(_t, arrays)),
                primary_impl="block")
        assert d.done()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        return
    if part == "tri_clusters":
        js = j_pt.with_tri_clusters(jbox, k=4, sup=2)
        ts = t_pt.with_tri_clusters(tbox, k=4, sup=2)
        assert ts.tri_clusters is not None
    else:
        js, ts = _with_part(jbox, part, jnp.asarray), \
            _with_part(tbox, part, _t)
    call, draws = RENDERS["SH"]
    want = np.asarray(call(j_pt, js, jcam, JCfg(**KW), interpret=True))
    d, jitters = draws(KW)
    cfg = RenderConfig(**KW)
    with d.patch():
        got, flags = call(t_pt, ts, tcam, cfg, return_flags=True)
    assert d.done() and not any(bool(v) for v in flags.values())
    got = got.numpy()
    assert np.isfinite(got).all() and got.std() > 0.05
    bad = _primary_id_mismatch((js, ts), (jcam, tcam), jitters, cfg)
    assert bad.mean() <= 0.002
    near = (np.abs(got - want) <= 1e-4).all(-1)
    if part == "mnd_center":
        assert near.mean() >= 0.99
        # the bulb fills the view's centre
        assert np.abs(got - np.asarray(call(j_pt, jbox, jcam, JCfg(**KW),
                                            interpret=True))).max() > 0.1
    else:
        assert near[~bad].all()
