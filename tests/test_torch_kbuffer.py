"""gsrt_torch's k-buffer path (`ops.kbuffer`, `ops.gaussian`'s ray-space
response, `render_reference`, `trace_gaussian_rays`) held against the JAX
package on the same NumPy inputs (CPU).

Tolerances:
  * the k-buffer ops: depths, alphas, counts and fronts exactly, ties
    included (equal depths are taken lowest position first, as
    `lax.top_k` takes them); composite colour and trans at rtol 1e-6 (the
    sum over the k slots may associate otherwise than the JAX einsum);
  * `invert_cov3d` and `ray_gaussian_response` at rtol 1e-6 against the
    JAX functions run op by op;
  * `render_reference`: passes and hits equal, trans at rtol 1e-4 / atol
    1e-5, colour at rtol 1e-3 / atol 1e-4 (the JAX suite's bounds between
    its own renderers, tests/test_renderer_vs_oracle.py:81-92); against
    the NumPy oracle on the demo scene the JAX suite's oracle bounds and
    passes equal;
  * `trace_gaussian_rays`: hits equal, trans at rtol 1e-5 / atol 1e-6,
    colour at rtol 1e-4 / atol 1e-5, against the JAX function run op by
    op (`jax.disable_jit`): under jit XLA fuses the ray-space response and
    rounds it otherwise, by up to 1e-3 in trans on a grazing ray.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_env  # noqa: F401
from gsrt.core.config import REFERENCE_DEMO as J_DEMO
from gsrt.core.config import RenderConfig as JCfg
from gsrt.models import gaussian_rt as j_rt
from gsrt.ops import gaussian as j_g
from gsrt.ops import kbuffer as j_kb
from gsrt.scene.catalog import demo_gauss_splat as j_demo
from gsrt.scene.catalog import random_cloud as j_random_cloud
from gsrt.utils.oracle import render_reference_oracle

from gsrt_torch import REFERENCE_DEMO, RenderConfig
from gsrt_torch.interop import camera_from_numpy, cloud_from_numpy
from gsrt_torch.models import gaussian_rt as t_rt
from gsrt_torch.ops import gaussian as t_g
from gsrt_torch.ops import kbuffer as t_kb

T = lambda a: torch.as_tensor(np.array(a))
TRACE_TOL = dict(trans=dict(rtol=1e-5, atol=1e-6),
                 color=dict(rtol=1e-4, atol=1e-5))


def _port(jc, jcam):
    c = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    cam = camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.fx),
                            np.asarray(jcam.fy), np.asarray(jcam.cx),
                            np.asarray(jcam.cy), jcam.width, jcam.height,
                            device="cpu")
    return c, cam


def _buffer_inputs(seed=0, rays=64, m=40, k=8):
    """Candidate depths with many exact ties (values on a coarse grid),
    some past init_depth, alphas and a validity mask."""
    rng = np.random.default_rng(seed)
    depth = (rng.integers(1, 12, (rays, m)) * 0.5).astype(np.float32)
    depth[:, :3] = 2e4                      # past the far clip
    alpha = rng.uniform(0.0, 0.99, (rays, m)).astype(np.float32)
    valid = rng.uniform(size=(rays, m)) < 0.6
    valid[:4] = False                       # rays with no hit
    count = rng.integers(0, k + 1, rays).astype(np.int32)
    trans = rng.uniform(0.1, 1.0, rays).astype(np.float32)
    color = rng.uniform(0.0, 1.0, (rays, 3)).astype(np.float32)
    k_color = rng.uniform(0.0, 2.0, (rays, k, 3)).astype(np.float32)
    return depth, alpha, valid, count, trans, color, k_color


@pytest.mark.parametrize("m", [40, 5])
def test_kbuffer_ops_match_jax(m):
    """The four ops, with ties among valid depths (and fewer candidates
    than slots when m = 5)."""
    k = 8
    depth, alpha, valid, count, trans, color, k_color = _buffer_inputs(m=m)
    jd, ja, jn = j_kb.topk_nearest(jnp.asarray(depth), jnp.asarray(alpha),
                                   jnp.asarray(valid), k, 1e4)
    td, ta, tn = t_kb.topk_nearest(T(depth), T(alpha), T(valid), k, 1e4)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # the tie rule is visible: equal depths in a row of the buffer
    assert (np.diff(td.numpy(), axis=-1) == 0).any()
    kd, ka = td.numpy(), ta.numpy()
    cnt = np.minimum(count, tn.numpy())
    np.testing.assert_array_equal(
        t_kb.advance_depth_front(T(trans), T(kd), T(cnt)).numpy(),
        np.asarray(j_kb.advance_depth_front(jnp.asarray(trans),
                                            jnp.asarray(kd),
                                            jnp.asarray(cnt))))
    np.testing.assert_allclose(
        t_kb.composite_transmittance(T(trans), T(ka), T(cnt)).numpy(),
        np.asarray(j_kb.composite_transmittance(
            jnp.asarray(trans), jnp.asarray(ka), jnp.asarray(cnt))),
        rtol=1e-6)
    tt, tc = t_kb.composite_color(T(trans), T(color), T(ka), T(k_color),
                                  T(cnt))
    jt, jc = j_kb.composite_color(jnp.asarray(trans), jnp.asarray(color),
                                  jnp.asarray(ka), jnp.asarray(k_color),
                                  jnp.asarray(cnt))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)


def test_merge_nearest_is_topk_of_concatenation():
    """Merging chunk by chunk keeps the k nearest of everything, lowest
    position first among equal depths: the same buffer as one selection
    over all candidates."""
    depth, alpha, valid, *_ = _buffer_inputs(seed=3, m=48)
    d = np.where(valid, depth, 1e4).astype(np.float32)
    a = np.where(valid, alpha, 0.0).astype(np.float32)
    ids = np.arange(d.shape[1])
    kd, ka, ki = (torch.full((d.shape[0], 8), 1e4), torch.zeros(d.shape[0], 8),
                  torch.zeros((d.shape[0], 8), dtype=torch.int64))
    for c0 in range(0, d.shape[1], 16):
        sl = slice(c0, c0 + 16)
        kd, ka, ki = t_kb.merge_nearest(kd, ka, ki, T(d[:, sl]), T(a[:, sl]),
                                        T(ids[sl]))
    order = np.lexsort((np.broadcast_to(ids, d.shape), d), axis=-1)[:, :8]
    np.testing.assert_array_equal(kd.numpy(),
                                  np.take_along_axis(d, order, -1))
    live = kd.numpy() < 1e4
    np.testing.assert_array_equal(ki.numpy()[live], order[live])


def test_ray_response_matches_jax():
    jc, _ = j_random_cloud(300, seed=4, width=32, height=32)
    cov = np.asarray(jc.cov3d)
    j_inv = np.asarray(j_g.invert_cov3d(jnp.asarray(cov)))
    t_inv = t_g.invert_cov3d(T(cov))
    np.testing.assert_allclose(t_inv.numpy(), j_inv, rtol=1e-6)
    rng = np.random.default_rng(5)
    o = (rng.normal(size=(64, 3)) * 2.5).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    means = np.asarray(jc.means)
    jt, jg = j_g.ray_gaussian_response(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(means),
                                       jnp.asarray(j_inv))
    tt, tg = t_g.ray_gaussian_response(T(o), T(d), T(means), T(j_inv))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    # leading batch dims broadcast, as the clustered tracer calls it
    bt, bg = t_g.ray_gaussian_response(T(o).reshape(4, 16, 3),
                                       T(d).reshape(4, 16, 3),
                                       T(means[:40]).reshape(4, 10, 3),
                                       T(j_inv[:40]).reshape(4, 10, 6))
    np.testing.assert_array_equal(bt[1].numpy(), tt[16:32, 10:20].numpy())
    np.testing.assert_array_equal(bg[3].numpy(), tg[48:, 30:40].numpy())


SCENES = {
    "demo": lambda: (j_demo(16, 16), J_DEMO, REFERENCE_DEMO),
    "random": lambda: (j_random_cloud(400, seed=11, width=40, height=32),
                       JCfg(width=40, height=32, conic_mode="standard",
                            max_passes=128, splat_chunk=96),
                       RenderConfig(width=40, height=32,
                                    conic_mode="standard", max_passes=128,
                                    splat_chunk=96)),
    "capped": lambda: (j_random_cloud(400, seed=11, width=40, height=32),
                       JCfg(width=40, height=32, conic_mode="standard",
                            max_passes=1, k=4),
                       RenderConfig(width=40, height=32,
                                    conic_mode="standard", max_passes=1,
                                    k=4)),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_render_reference_matches_jax(scene):
    """GaussianRayTracer(cfg, "reference") against the JAX package's
    render_reference: the paper's configuration on its demo scene, a
    random cloud, and one where every covered pixel stops at max_passes."""
    (jc, jcam), jcfg, cfg = SCENES[scene]()
    c, cam = _port(jc, jcam)
    j = j_rt.render_reference(jc, jcam, jcfg)
    t = t_rt.GaussianRayTracer(cfg, "reference", device="cpu")(c, cam)
    np.testing.assert_array_equal(t.passes.numpy(), np.asarray(j.passes))
    np.testing.assert_array_equal(t.hits.numpy(), np.asarray(j.hits))
    np.testing.assert_allclose(t.trans.numpy(), np.asarray(j.trans),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color),
                               rtol=1e-3, atol=1e-4)
    assert t.hits.max() > (cfg.k if scene == "random" else 1)
    if scene == "capped":
        assert t.passes.max() == 1 and (t.hits.numpy() <= 4).all()
    else:   # the k-buffer passes compute the one sorted sweep's image
        f = t_rt.render_fast(c, cam, cfg)
        np.testing.assert_allclose(t.trans.numpy(), f.trans.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_render_reference_demo_matches_oracle():
    jc, jcam = j_demo(16, 16)
    c, cam = _port(jc, jcam)
    cfg = REFERENCE_DEMO.replace(max_passes=16)
    dirs = np.asarray(jc.means) - np.asarray(jcam.position)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    from gsrt.ops.sh import eval_sh
    sh_dc = np.asarray(eval_sh(jc.sh, jnp.asarray(dirs), jc.sh_degree))
    want_t, want_p, want_c = render_reference_oracle(
        means=np.asarray(jc.means), cov3d=np.asarray(jc.cov3d),
        opacity=np.asarray(jc.opacity), view=np.asarray(jcam.view),
        fx=float(jcam.fx), fy=float(jcam.fy), cx=float(jcam.cx),
        cy=float(jcam.cy), width=16, height=16, k=cfg.k,
        max_passes=cfg.max_passes, use_exp_lut=True, conic_mode="reference",
        sh_dc=sh_dc)
    out = t_rt.render_reference(c, cam, cfg)
    np.testing.assert_array_equal(out.passes.numpy(), want_p)
    np.testing.assert_allclose(out.trans.numpy(), want_t, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(out.color.numpy(), want_c, rtol=2e-3,
                               atol=3e-3)
    assert out.passes.max() >= 1 and float(out.trans.min()) < 0.5


def _rays(n, seed):
    """Rays from around the camera of `random_cloud` into its cloud."""
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, -1.0]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * 0.15 + [0.0, 0.0, 1.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("colors", ["given", "sh_origin", "dc"])
def test_trace_gaussian_rays_matches_jax(colors):
    """Free rays, each colour source, per-ray t_max windows (some past
    init_depth, which clamps them), a stop at max_passes·k hits."""
    jc, jcam = j_random_cloud(240, seed=0, extent=1.5,
                              scale_range=(0.1, 0.4), width=32, height=32)
    c, _ = _port(jc, jcam)
    o, d = _rays(96, seed=1)
    t_max = np.random.default_rng(2).uniform(2.0, 6.0, 96).astype(
        np.float32)
    t_max[::7] = 5e4
    kw = dict(width=32, height=32, conic_mode="standard", k=4, max_passes=3)
    jkw, tkw = {}, {}
    if colors == "given":
        col = np.abs(np.sin(np.asarray(jc.means) * 5.0)).astype(np.float32)
        jkw["colors"], tkw["colors"] = jnp.asarray(col), T(col)
    elif colors == "sh_origin":
        jkw["sh_origin"] = jnp.asarray([0.0, 0.0, -1.0])
        tkw["sh_origin"] = [0.0, 0.0, -1.0]
    with jax.disable_jit():
        jt, jcol, jh = j_rt.trace_gaussian_rays(
            jc, jnp.asarray(o), jnp.asarray(d), JCfg(**kw),
            t_max=jnp.asarray(t_max), **jkw)
    tt, tcol, th = t_rt.trace_gaussian_rays(c, T(o), T(d), RenderConfig(**kw),
                                            t_max=T(t_max), **tkw)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt),
                               **TRACE_TOL["trans"])
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol),
                               **TRACE_TOL["color"])
    assert th.max() >= 12 and (th.numpy() <= 12 + 3).all()  # the stop rule
