"""gsrt_torch per-splat math, scene factories, packers and host counters,
held against the JAX package on the same NumPy inputs (CPU).

Tolerances: float math is compared at rtol = atol = 1e-5 (f32
reassociation between XLA and PyTorch kernels); integer results, packed
words and NumPy RNG draws are compared exactly.
"""

from __future__ import annotations

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsrt.core import types as j_types
from gsrt.models import gaussian_rt as j_rt
from gsrt.ops import explut as j_explut
from gsrt.ops import gaussian as j_gauss
from gsrt.ops import sh as j_sh
from gsrt.ops import tile_binning as j_tb
from gsrt.scene import catalog as j_catalog

from gsrt_torch import RenderConfig
from gsrt_torch.core import types as t_types
from gsrt_torch.interop import (camera_from_numpy, cloud_from_numpy,
                                scene_from_numpy)
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import explut as t_explut
from gsrt_torch.ops import gaussian as t_gauss
from gsrt_torch.ops import sh as t_sh
from gsrt_torch.ops import tile_binning as t_tb
from gsrt_torch.scene import catalog as t_catalog
from gsrt_torch.scene import primitives_catalog as t_primcat

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _n(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _scene(n=600, seed=0, width=256, height=256, **kw):
    jc, jcam = j_catalog.random_cloud(n, seed=seed, width=width,
                                      height=height, **kw)
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), jcam.width, jcam.height,
                            device="cpu")
    return jc, jcam, c, cam


def test_quat_scale_to_cov3d():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(257, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (257, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _n(t_gauss.quat_scale_to_cov3d(_t(q), _t(s))),
        np.asarray(j_gauss.quat_scale_to_cov3d(jnp.asarray(q),
                                               jnp.asarray(s))), **TOL)


@pytest.mark.parametrize("conic_mode", ["standard", "reference"])
def test_project_gaussians(conic_mode):
    jc, jcam, c, cam = _scene()
    j_out = j_gauss.project_gaussians(jc.means, jc.cov3d, jcam,
                                      conic_mode=conic_mode,
                                      cov2d_dilation=0.3)
    t_out = t_gauss.project_gaussians(c.means, c.cov3d, cam,
                                      conic_mode=conic_mode,
                                      cov2d_dilation=0.3)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("conic_mode", ["standard", "reference"])
def test_project_gaussians_fm(conic_mode):
    jc, jcam, c, cam = _scene(seed=1)
    j_out = j_gauss.project_gaussians_fm(jc.means.T, jc.cov3d.T, jcam,
                                         conic_mode=conic_mode)
    t_out = t_gauss.project_gaussians_fm(c.means.T, c.cov3d.T, cam,
                                         conic_mode=conic_mode)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("with_opacity", [False, True])
def test_screen_extents(with_opacity):
    jc, jcam, c, cam = _scene(seed=2)
    _, _, jq, _, _ = j_gauss.project_gaussians(jc.means, jc.cov3d, jcam)
    _, _, tq, _, _ = t_gauss.project_gaussians(c.means, c.cov3d, cam)
    j_ext = j_gauss.screen_extents(
        jq, "standard", 5.6, opacity=jc.opacity if with_opacity else None)
    t_ext = t_gauss.screen_extents(
        tq, "standard", 5.6, opacity=c.opacity if with_opacity else None)
    for a, b in zip(t_ext, j_ext):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)
    qa, qb, qc = (jq[:, i] for i in range(3))
    j_abc = j_gauss.screen_extents_abc(qa, qb, qc, "standard", 5.6)
    t_abc = t_gauss.screen_extents_abc(_t(qa), _t(qb), _t(qc), "standard",
                                       5.6)
    for a, b in zip(t_abc, j_abc):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)


def test_eval_gaussian_response():
    rng = np.random.default_rng(4)
    pix = rng.uniform(0, 64, (300, 2)).astype(np.float32)
    mean = rng.uniform(0, 64, (300, 2)).astype(np.float32)
    quad = rng.uniform(-0.2, 1.0, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _n(t_gauss.eval_gaussian_response(_t(pix), _t(mean), _t(quad))),
        np.asarray(j_gauss.eval_gaussian_response(
            jnp.asarray(pix), jnp.asarray(mean), jnp.asarray(quad))), **TOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(0, 0.5, (200, 16, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        _n(t_sh.eval_sh(_t(sh), _t(d), degree)),
        np.asarray(j_sh.eval_sh(jnp.asarray(sh), jnp.asarray(d), degree)),
        **TOL)
    shT = np.ascontiguousarray(np.transpose(sh, (1, 2, 0)))
    t_fm = t_sh.eval_sh_fm(_t(shT), *(_t(d[:, i]) for i in range(3)),
                           degree)
    j_fm = j_sh.eval_sh_fm(jnp.asarray(shT),
                           *(jnp.asarray(d[:, i]) for i in range(3)), degree)
    for a, b in zip(t_fm, j_fm):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)


def test_explut():
    lut = t_explut.build_exp_lut(device="cpu")
    np.testing.assert_array_equal(_n(lut),
                                  np.asarray(j_explut.build_exp_lut()))
    x = np.linspace(0.0, 9.0, 1001, dtype=np.float32)
    np.testing.assert_allclose(
        _n(t_explut.linear_exp(_t(x), lut)),
        np.asarray(j_explut.linear_exp(jnp.asarray(x),
                                       j_explut.build_exp_lut())), **TOL)
    np.testing.assert_allclose(_n(t_explut.exp_neg(_t(x))), np.exp(-x),
                               **TOL)


def test_random_cloud_same_draws():
    jc, jcam = j_catalog.random_cloud(800, seed=5, width=320, height=200)
    c, cam = t_catalog.random_cloud(800, seed=5, width=320, height=200,
                                    device="cpu")
    for name in ("means", "opacity", "sh"):
        np.testing.assert_array_equal(_n(getattr(c, name)),
                                      np.asarray(getattr(jc, name)))
    np.testing.assert_allclose(_n(c.cov3d), np.asarray(jc.cov3d), **TOL)
    np.testing.assert_array_equal(_n(cam.view), np.asarray(jcam.view))
    for name in ("fx", "fy", "cx", "cy"):
        assert float(getattr(cam, name)) == float(getattr(jcam, name))
    assert (cam.width, cam.height) == (jcam.width, jcam.height)
    np.testing.assert_allclose(_n(cam.position), np.asarray(jcam.position),
                               **TOL)
    assert c.sh_degree == jc.sh_degree == 3


def test_demo_gauss_splat():
    jc, jcam = j_catalog.demo_gauss_splat()
    c, cam = t_catalog.demo_gauss_splat(device="cpu")
    for a, b in zip(c, jc):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)
    np.testing.assert_array_equal(_n(cam.view), np.asarray(jcam.view))
    assert float(cam.fx) == float(jcam.fx)


@pytest.mark.parametrize("eye,target", [((0, 0, -1), (0, 0, 4)),
                                        ((1, 2, 3), (0, -1, 0)),
                                        ((0, 5, 0), (0, 0, 0))])
def test_look_at(eye, target):
    np.testing.assert_array_equal(t_types.look_at(eye, target),
                                  j_types.look_at(eye, target))


def test_tile_spans_and_histogram():
    rng = np.random.default_rng(6)
    n = 2000
    cx = rng.uniform(-50, 330, n).astype(np.float32)
    cy = rng.uniform(-50, 250, n).astype(np.float32)
    rx = rng.uniform(0, 60, n).astype(np.float32)
    ry = rng.uniform(0, 60, n).astype(np.float32)
    rx[::17] = 0.0
    alive = rng.uniform(size=n) > 0.1
    args = (320, 200, 32, 16)
    j_sp = j_tb.compute_tile_spans(*(jnp.asarray(a) for a in
                                     (cx, cy, rx, ry, alive)), *args)
    t_sp = t_tb.compute_tile_spans(*(_t(a) for a in (cx, cy, rx, ry, alive)),
                                   *args)
    for a, b in zip(t_sp, j_sp):
        np.testing.assert_array_equal(_n(a), np.asarray(b))
    x0, x1, y0, y1, touched = t_sp
    ntx, nty = t_tb.tile_extent(*args)
    hist = t_tb.tile_histogram(x0, x1, y0, y1, touched > 0, ntx, nty)
    j_hist = j_tb.tile_histogram(*(jnp.asarray(np.asarray(b))
                                   for b in j_sp[:4]),
                                 jnp.asarray(np.asarray(j_sp[4]) > 0),
                                 ntx, nty)
    np.testing.assert_array_equal(_n(hist), np.asarray(j_hist))
    assert int(hist.sum()) == int(touched.sum())


def test_packers():
    rng = np.random.default_rng(7)
    n = 4096
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)
    hi, lo = f(-1e3, 1e3), f(-5, 5)
    np.testing.assert_array_equal(
        _n(t_tb.pack_bf16_pair(_t(hi), _t(lo))),
        np.asarray(j_tb.pack_bf16_pair(jnp.asarray(hi), jnp.asarray(lo))))
    w = t_tb.pack_bf16_pair(_t(hi), _t(lo))
    np.testing.assert_array_equal(_n(t_tb.unpack_bf16_hi(w)),
                                  np.asarray(j_tb.unpack_bf16_hi(
                                      jnp.asarray(_n(w)))))
    np.testing.assert_array_equal(_n(t_tb.unpack_bf16_lo(w)),
                                  np.asarray(j_tb.unpack_bf16_lo(
                                      jnp.asarray(_n(w)))))
    r, g, b, o = f(-0.5, 4.5), f(0, 1.2), f(0.9, 1.1), f(0, 1)
    np.testing.assert_array_equal(
        _n(t_tb.pack_rgba8(*(_t(a) for a in (r, g, b, o)))),
        np.asarray(j_tb.pack_rgba8(*(jnp.asarray(a) for a in (r, g, b, o)))))
    mx, my = f(-3000, 3000), f(-70, 70)
    mx[:8] = [-64, 63.999, 64, -64.001, 2047.4, 2048, -2048, 0.00195]
    np.testing.assert_array_equal(
        _n(t_tb.pack_mean_rel(_t(mx), _t(my))),
        np.asarray(j_tb.pack_mean_rel(jnp.asarray(mx), jnp.asarray(my))))


def test_group_rows_k_and_pair_bucket():
    for ntx in range(1, 140):
        assert t_tb.group_rows_k(ntx) == j_tb.group_rows_k(ntx)
    for need in (0, 1, 5000, 16384, 16385, 123457, 3_150_000, 9_999_999):
        assert t_rt.pair_bucket(need) == j_rt.pair_bucket(need)


def test_host_counters_match():
    jc, jcam, c, cam = _scene(n=3000, seed=0)
    cfg = RenderConfig(width=256, height=256)
    from gsrt.core.config import RenderConfig as JCfg
    jcfg = JCfg(width=256, height=256)
    assert t_rt.count_units_numpy(c, cam, cfg, 16) == \
        j_rt.count_units_numpy(jc, jcam, jcfg, 16)
    assert t_rt.count_pairs_numpy(c, cam, cfg) == \
        j_rt.count_pairs_numpy(jc, jcam, jcfg)


@pytest.mark.parametrize("with_depth", [False, True])
def test_render_fast_matches_jax(with_depth):
    # the port's oracle against the JAX package's: same sort, same chunked
    # sweep; 1e-4 covers f32 reassociation of the per-chunk cumprod/dot
    jc, jcam, c, cam = _scene(n=700, seed=3, width=64, height=48)
    from gsrt.core.config import RenderConfig as JCfg
    kw = dict(width=64, height=48, splat_chunk=128)
    j = j_rt.render_fast(jc, jcam, JCfg(**kw), with_depth=with_depth)
    t = t_rt.render_fast(c, cam, RenderConfig(**kw), with_depth=with_depth)
    np.testing.assert_allclose(_n(t.color), np.asarray(j.color), atol=1e-4)
    np.testing.assert_allclose(_n(t.trans), np.asarray(j.trans), atol=1e-4)
    np.testing.assert_array_equal(_n(t.hits), np.asarray(j.hits))
    if with_depth:
        np.testing.assert_allclose(_n(t.depth), np.asarray(j.depth),
                                   rtol=1e-4, atol=1e-4)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_gsrt():
    files = sorted((REPO / "gsrt_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 10
    # the triangle path's modules are among them
    names = {str(f.relative_to(REPO / "gsrt_torch")) for f in files[:-1]}
    assert {"ops/primitives.py", "ops/morton.py", "ops/clusters.py",
            "ops/tri_kernel.py", "ops/tri_binning.py",
            "models/path_tracer.py", "scene/primitives_catalog.py",
            "interop.py", "ops/mip.py", "ops/bvh.py", "scene/obj.py",
            "scene/ply.py", "scene/instancing.py",
            "scene/reference_scenes.py", "native.py"} <= names
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "optax", "gsrt")]
    assert not bad, bad


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        c, cam = t_catalog.random_cloud(10)
        assert c.means.is_cuda and cam.view.is_cuda
        assert t_explut.build_exp_lut().is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_catalog.random_cloud(10)
    with pytest.raises(RuntimeError):
        t_rt.GaussianRayTracer(RenderConfig(), "tiled")
    with pytest.raises(RuntimeError):
        t_explut.build_exp_lut()
    with pytest.raises(RuntimeError):
        cloud_from_numpy(np.zeros((1, 3)), np.zeros((1, 6)), np.zeros(1),
                         np.zeros((1, 1, 3)))
    with pytest.raises(RuntimeError):
        t_primcat.cornell_box(16, 16)
    with pytest.raises(RuntimeError):
        scene_from_numpy({"materials": {}})
    c, _ = t_catalog.random_cloud(10, device="cpu")
    assert c.device.type == "cpu"
