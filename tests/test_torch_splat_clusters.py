"""gsrt_torch's clustered splat tracing (`ops.splat_clusters`) and splats in
path-traced scenes (`models.path_tracer` with `gaussians` /
`gauss_clusters`), held against the JAX package on the same NumPy inputs
(CPU).

The clustered tracer runs on clusters carried over from the JAX package
(`interop.splat_clusters_from_numpy`), so both trace the same Morton
order. Tolerances:
  * traced rays: hits equal, trans at rtol 1e-5 / atol 1e-6, colour at
    rtol 1e-4 / atol 1e-5 (tests/test_splat_clusters.py:26-41's bounds),
    against the JAX functions run op by op (`jax.disable_jit`; under jit
    XLA rounds the fused ray-space response otherwise); overflow flags
    equal; the port's own clusters equal the JAX package's arrays exactly
    on a cloud without Morton ties;
  * the mixed scene, brute force against clustered (one generator's
    draws): rtol 5e-3 / atol 1e-3 (tests/test_splat_clusters.py:108-113);
    the properties tests/test_mixed_scene.py checks, with its margins;
  * the mixed scene against the JAX package's render (jit; the port's
    draws patched to the JAX package's, as tests/test_torch_pathtracer.py
    does): atol 1e-3 on at least 99% of pixels and the mean colour within
    2e-3. A ray that grazes the mirror sphere's rim can hit it in one
    package and miss it in the other (a last-ulp difference), which
    sends its path elsewhere: 1 pixel of 144 here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import path_tracer as j_pt
from gsrt.ops import splat_clusters as j_sc
from gsrt.scene import primitives_catalog as j_cat
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import RenderConfig
from gsrt_torch.core.types import GaussianCloud, look_at, make_camera
from gsrt_torch.interop import (cloud_from_numpy, scene_from_numpy,
                                splat_clusters_from_numpy)
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import splat_clusters as t_sc
from gsrt_torch.ops.gaussian import quat_scale_to_cov3d
from gsrt_torch.ops.sh import C0, eval_sh
from gsrt_torch.scene import primitives_catalog as t_cat
from test_torch_pathtracer import _camera, _fields, _pt_draws

T = lambda a: torch.as_tensor(np.array(a))
TOL = dict(trans=dict(rtol=1e-5, atol=1e-6), color=dict(rtol=1e-4,
                                                       atol=1e-5))
CFG = dict(width=32, height=32, conic_mode="standard", k=16)


def _carried(jsc):
    cl = jsc.clusters
    return splat_clusters_from_numpy(
        *(np.asarray(a) for a in (cl.cl_min, cl.cl_max, cl.sup_min,
                                  cl.sup_max, cl.valid)), cl.sup,
        *(np.asarray(a) for a in (jsc.means, jsc.cov_inv, jsc.opacity,
                                  jsc.colors)), device="cpu")


def _rays(n, seed):
    """Rays from around the camera of `random_cloud` into its cloud, some
    crossing it sideways."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.5 + [0.0, 0.0, -1.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, 1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def cloud():
    """(JAX cloud, port cloud, colours, JAX clusters, carried clusters)."""
    jc, _ = j_random_cloud(360, seed=0, extent=1.5, scale_range=(0.05, 0.3),
                           width=32, height=32)
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    col = np.abs(np.sin(np.asarray(jc.means) * 5.0)).astype(np.float32)
    jsc = j_sc.build_splat_clusters(jc, JCfg(**CFG), jnp.asarray(col), k=64,
                                    sup=1)
    return jc, c, col, jsc, _carried(jsc)


def test_build_splat_clusters_matches_jax(cloud):
    jc, c, col, jsc, _ = cloud
    np.testing.assert_allclose(
        t_sc.splat_world_radius(c, RenderConfig(**CFG)).numpy(),
        np.asarray(j_sc.splat_world_radius(jc, JCfg(**CFG))), rtol=1e-6)
    own = t_sc.build_splat_clusters(c, RenderConfig(**CFG), T(col), k=64,
                                    sup=1)
    for f in ("means", "cov_inv", "opacity", "colors"):
        np.testing.assert_array_equal(getattr(own, f).numpy(),
                                      np.asarray(getattr(jsc, f)), f)
    for f in ("sup_min", "sup_max", "valid"):
        np.testing.assert_array_equal(getattr(own.clusters, f).numpy(),
                                      np.asarray(getattr(jsc.clusters, f)), f)


@pytest.mark.parametrize("case", ["all", "ragged", "overflow"])
def test_clustered_matches_jax(cloud, case):
    """Carried clusters, per-ray t_max: every super-cluster allowed (no
    overflow); 100 rays in blocks of 64 (padding must not leak); s_max 1
    (overflow: both packages drop the same clusters)."""
    jc, c, col, jsc, tsc = cloud
    ms = jsc.clusters.sup_min.shape[0]
    n, rb, s_max = dict(all=(128, 64, ms), ragged=(100, 64, ms),
                        overflow=(64, 64, 1))[case]
    o, d = _rays(n, seed=1)
    t_max = np.random.default_rng(2).uniform(2.0, 6.0, n).astype(np.float32)
    with jax.disable_jit():
        jt, jcol, jh, jovf = j_sc.trace_gaussian_rays_clustered(
            jsc, jnp.asarray(o), jnp.asarray(d), JCfg(**CFG),
            t_max=jnp.asarray(t_max), rb=rb, s_max=s_max)
    tt, tcol, th, tovf = t_sc.trace_gaussian_rays_clustered(
        tsc, T(o), T(d), RenderConfig(**CFG), t_max=T(t_max), rb=rb,
        s_max=s_max)
    assert tt.shape == (n,) and tcol.shape == (n, 3)
    assert bool(tovf) == bool(jovf) == (case == "overflow")
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL["trans"])
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol),
                               **TOL["color"])
    assert th.max() > 16
    if case != "overflow":   # brute force sees the same splats
        bt, bcol, bh = t_rt.trace_gaussian_rays(c, T(o), T(d),
                                                RenderConfig(**CFG),
                                                colors=T(col), t_max=T(t_max))
        np.testing.assert_array_equal(bh.numpy(), th.numpy())
        np.testing.assert_allclose(tt.numpy(), bt.numpy(), **TOL["trans"])


def test_plan_visits_culls_and_matches_jax():
    """A coherent bundle past the near side of a spread-out cloud visits
    few super-clusters, in ascending order, the sentinel MS past its list:
    the same lists as the JAX package on carried clusters."""
    jc, _ = j_random_cloud(20000, seed=2, width=32, height=32)
    jsc = j_sc.build_splat_clusters(jc, JCfg(**CFG),
                                    jnp.full((20000, 3), 0.5), k=64, sup=8)
    tsc = _carried(jsc)
    ms = jsc.clusters.sup_min.shape[0]
    rng = np.random.default_rng(3)
    o = np.tile([[4.0, 0.0, 0.0]], (128, 1)).astype(np.float32)
    d = np.tile([-1.0, 0.0, 0.0], (128, 1)) + 0.05 * rng.normal(
        size=(128, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    lo, hi = np.zeros(128, np.float32), np.full(128, 1e9, np.float32)
    j_ids, j_n, j_ovf = j_sc.plan_visits(jsc, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(lo), jnp.asarray(hi),
                                         rb=64, s_max=ms + 2)
    t_ids, t_n, t_ovf = t_sc.plan_visits(tsc, T(o), T(d), T(lo), T(hi),
                                         rb=64, s_max=ms + 2)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    assert not bool(t_ovf) and 0 < int(t_n.max()) < ms * 0.6
    assert (t_ids[:, -2:] == ms).all()


# --- splats in a path-traced scene ---

def _mirror_scene(device="cpu"):
    b = t_cat._SceneBuilder()
    b.quad((-4, -4, 0), (4, -4, 0), (4, 4, 0), (-4, 4, 0),
           b.metallic((0.95, 0.95, 0.95), 0.0))
    cam = make_camera(look_at((0, 0, 6.0), (0, 0, 0.0)), 50.0, 24, 24,
                      device=device)
    return b.build(device), cam


def _single_splat(center, scale, opacity, rgb):
    sh = ((torch.tensor([rgb]) - 0.5) / C0)[:, None, :]
    return GaussianCloud(
        means=torch.tensor([center]),
        cov3d=quat_scale_to_cov3d(torch.tensor([[1.0, 0, 0, 0]]),
                                  torch.tensor([[scale] * 3])),
        opacity=torch.tensor([opacity]), sh=sh)


MIXED = dict(width=24, height=24, samples=1, bounces=3, has_sky=True,
             gamma_correction=False)


@pytest.mark.parametrize("case", ["primary", "mirror", "empty", "occluded"])
def test_mixed_scene_properties(case):
    """tests/test_mixed_scene.py's four cases on the port: a red splat
    between camera and mirror tints the centre pixel; one behind the
    camera shows only through the mirror; a cloud of opacity 0 changes
    nothing; a splat behind an opaque wall contributes nothing (the
    segment stops at the surface hit)."""
    scene, cam = _mirror_scene()
    cfg = RenderConfig(**MIXED)
    center, scale, op = dict(primary=((0.0, 0.0, 3.0), 0.6, 0.95),
                             mirror=((0.0, 0.0, 9.0), 0.8, 0.95),
                             empty=((0.0, 0.0, 3.0), 0.3, 0.0),
                             occluded=((0.0, 0.0, -3.0), 0.6, 0.95))[case]
    if case == "occluded":
        b = t_cat._SceneBuilder()
        b.quad((-4, -4, 0), (4, -4, 0), (4, 4, 0), (-4, 4, 0),
               b.lambertian((0.1, 0.1, 0.1)))
        scene, cfg = b.build("cpu"), cfg.replace(bounces=1)
    cloud = _single_splat(center, scale, op, (1.0, 0.1, 0.1))
    base = t_pt.render_path_traced(scene, cam, cfg, seed=0).numpy()
    mixed = t_pt.render_path_traced(scene, cam, cfg, seed=0,
                                    gaussians=cloud).numpy()
    c, c0 = mixed[12, 12], base[12, 12]
    if case == "primary":
        assert c[0] > c0[0] + 0.1 and c[0] > c[2] * 1.5, (c, c0)
    elif case == "mirror":
        assert c[0] > c0[0] + 0.05 and c[0] > c[2] * 1.2, (c, c0)
    else:
        np.testing.assert_allclose(mixed, base, atol=1e-5)


def test_mirror_in_gaussians_brute_force_vs_clustered():
    """The catalog scene (port): brute force against clusters of 8 splats
    (4 super-clusters), with one generator's draws; the calibrated render
    from gauss_s_max = 1 reports the overflow, grows, and ends without
    it."""
    scene, cloud, cam, opts = t_cat.mirror_in_gaussians(24, 24,
                                                        device="cpu")
    cfg = RenderConfig(width=24, height=24, samples=1, bounces=3,
                       has_sky=opts["has_sky"], gamma_correction=False)
    brute = t_pt.render_path_traced(scene, cam, cfg, seed=0,
                                    gaussians=cloud)
    bare = t_pt.render_path_traced(scene, cam, cfg, seed=0)
    assert torch.isfinite(brute).all() and (brute - bare).abs().max() > 0.05
    from gsrt_torch.models.gaussian_rt import unit_dirs
    colors = eval_sh(cloud.sh, unit_dirs(cloud.means, cam.position),
                     cloud.sh_degree)
    sc = t_sc.build_splat_clusters(cloud, cfg, colors, k=8, sup=2)
    ms = sc.clusters.sup_min.shape[0]
    clus, flags = t_pt.render_path_traced(
        scene, cam, cfg, seed=0, gauss_clusters=sc, gauss_s_max=ms,
        gauss_rb=64, return_flags=True)
    assert not any(bool(v) for v in flags.values())
    np.testing.assert_allclose(clus.numpy(), brute.numpy(), rtol=5e-3,
                               atol=1e-3)
    img, info = t_pt.render_path_traced_calibrated(
        scene, cam, cfg, seed=0, gauss_clusters=sc, gauss_s_max=1,
        gauss_rb=64)
    assert info["retries"] >= 1 and info["gauss_s_max"] > 1
    assert not info["flags"]["gauss_visits_overflow"]
    np.testing.assert_allclose(img.numpy(), clus.numpy(), atol=1e-6)


def test_mirror_in_gaussians_matches_jax():
    """The catalog scene's arrays equal the JAX package's; its render
    (brute force, 2 bounces, 12x12) against the JAX package's, draws
    patched."""
    W = H = 12
    js, jcl, jcam, _ = j_cat.mirror_in_gaussians(W, H, n_splats=30)
    ts, tcl, tcam, _ = t_cat.mirror_in_gaussians(W, H, n_splats=30,
                                                 device="cpu")
    for f in ("means", "opacity", "sh"):
        np.testing.assert_array_equal(getattr(tcl, f).numpy(),
                                      np.asarray(getattr(jcl, f)), f)
    np.testing.assert_allclose(tcl.cov3d.numpy(), np.asarray(jcl.cov3d),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tcam.view.numpy(), np.asarray(jcam.view))
    kw = dict(width=W, height=H, samples=1, bounces=2, has_sky=True,
              gamma_correction=False)
    want = np.asarray(j_pt.render_path_traced(js, jcam, JCfg(**kw), seed=0,
                                              gaussians=jcl, interpret=True))
    d, _ = _pt_draws(0, 1, 2, W * H)
    with d.patch():
        got = t_pt.render_path_traced(
            scene_from_numpy(_fields(js), device="cpu"), _camera(jcam),
            RenderConfig(**kw), seed=0,
            gaussians=cloud_from_numpy(*(np.asarray(a) for a in jcl),
                                       device="cpu")).numpy()
    assert d.done()
    near = (np.abs(got - want) <= 1e-3).all(-1)
    assert near.mean() >= 0.99, np.argwhere(~near)
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)),
                               atol=2e-3)
    assert got.std() > 0.05
