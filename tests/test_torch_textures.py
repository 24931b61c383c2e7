"""gsrt_torch's textures, mip pyramids and alpha cutouts
(`ops.mip`, `models.path_tracer`: `sample_texture`, `with_texture_mips`,
`_sample_alpha`, `_closest_hit_cutout`, `render_foveated`), held against
the JAX package on the CPU.

Tolerances: samplers, texel densities and LODs at atol 1e-6; the mip
atlas and each material's texel density bit-equal (both built in NumPy,
the densities summed in triangle order). Cutout hits: hit, material and
t equal. The PT renders (48×32, one sample, 3 bounces; the planets'
sphere-UV textures, a textured OBJ mesh with mips, an alpha-cutout OBJ
mesh) run the JAX package op by op with its draws and camera rays patched
in and hold the soup rule: at least 99.5% of pixels within atol 1e-4, the
mean colour within 2e-3. `render_foveated`'s rings equal the averages of
the one-sample renders they are made of, bit for bit.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsrt.core.config import RenderConfig as JCfg
from gsrt.core import types as j_types
from gsrt.models import path_tracer as j_pt
from gsrt.ops import mip as j_mip
from gsrt.scene import obj as j_obj
from gsrt.scene import primitives_catalog as j_cat

from gsrt_torch import RenderConfig
from gsrt_torch.interop import scene_from_numpy
from gsrt_torch.models import path_tracer as t_pt
from gsrt_torch.ops import mip as t_mip
from gsrt_torch.scene import primitives_catalog as t_cat

from test_torch_pathtracer import _camera, _fields, _pt_draws
from test_torch_procedural import jax_camera_rays

J, T = jnp.asarray, torch.as_tensor
W, H = 48, 32


def _atlas(seed=0, nt=3, res=16, channels=3):
    rng = np.random.default_rng(seed)
    shape = (nt, res, res) + ((channels,) if channels else ())
    return rng.random(shape).astype(np.float32)


def _uv_ids(n, nt, seed=1):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.1, 1.1, (n, 2)).astype(np.float32)
    return uv, rng.integers(-1, nt, n).astype(np.int32)


def test_sample_texture_matches_jax():
    tex = _atlas()
    uv, tid = _uv_ids(2000, 3)
    want = j_pt.sample_texture(J(tex), J(tid), J(uv))
    got = t_pt.sample_texture(T(tex), T(tid), T(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert (got.numpy()[tid < 0] == 1).all()


@pytest.mark.parametrize("channels", [3, 0])
def test_mip_atlas_and_lod_sampling_match_jax(channels):
    tex = _atlas(channels=channels, res=32)
    jm = j_mip.build_mip_atlas(tex)
    tm = t_mip.build_mip_atlas(tex, device="cpu")
    assert (tm.n_levels, tm.base_h, tm.base_w) == (jm.n_levels, jm.base_h,
                                                   jm.base_w)
    assert torch.equal(tm.data, T(np.asarray(jm.data)))
    uv, tid = _uv_ids(3000, 3, seed=2)
    lod = np.random.default_rng(3).uniform(-1, 7, 3000).astype(np.float32)
    want = j_mip.sample_texture_lod(jm, J(tid), J(uv), J(lod))
    got = t_mip.sample_texture_lod(tm, T(tid), T(uv), T(lod))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    packed = t_pt._mip_from_packed(tm.data)
    assert packed._replace(data=None) == tm._replace(data=None)


def test_texel_density_and_cone_lod_match_jax():
    rng = np.random.default_rng(4)
    v = [rng.normal(size=(500, 3)).astype(np.float32) for _ in range(3)]
    uv = [rng.random((500, 2)).astype(np.float32) for _ in range(3)]
    uv[2][:20] = uv[0][:20]                      # degenerate UVs: density 0
    want = np.asarray(j_mip.triangle_texel_density(*map(J, v + uv), 256))
    got = t_mip.triangle_texel_density(*map(T, v + uv), 256).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert (got[:20] == 0).all()
    t = rng.uniform(0, 50, 500).astype(np.float32)
    t[:5] = np.inf
    np.testing.assert_allclose(
        t_mip.ray_cone_lod(T(t), 1.0 / 300.0, T(got)).numpy(),
        np.asarray(j_mip.ray_cone_lod(J(t), 1.0 / 300.0, J(want))),
        atol=1e-6)


# --- OBJ meshes with texcoords, written by the tests ---

def _write_png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


def _mesh_dir(tmp, cutout: bool) -> str:
    """A textured floor quad and 12 tilted cards with full UVs; the cards'
    texture a 2-tone checker, the floor's a fine one. With `cutout`, the
    cards' map_d cuts a blade shape (about half the texels)."""
    pytest.importorskip("PIL")
    y, x = np.mgrid[:64, :64]
    card = np.zeros((64, 64, 4), np.uint8)
    card[..., 0] = np.where((x // 8 + y // 8) % 2, 220, 40)
    card[..., 1] = np.where((x // 16) % 2, 180, 60)
    card[..., 2] = 90
    blade = np.abs(x - 32) < (64 - y) * 0.45
    card[..., 3] = np.where(blade, 255, 0)
    _write_png(os.path.join(tmp, "card.png"), card)
    floor = np.where(((x // 2 + y // 2) % 2)[..., None], 230, 25).astype(
        np.uint8).repeat(3, -1)
    _write_png(os.path.join(tmp, "floor.png"), floor)
    with open(os.path.join(tmp, "mesh.mtl"), "w") as f:
        f.write("newmtl floor\nKd 0.8 0.8 0.8\nmap_Kd floor.png\n")
        f.write("newmtl card\nKd 0.9 0.9 0.9\nmap_Kd card.png\n")
        if cutout:
            f.write("map_d card.png\n")
    rng = np.random.default_rng(7)
    lines = ["mtllib mesh.mtl", "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
             "v -6 0 -6", "v 6 0 -6", "v 6 0 6", "v -6 0 6",
             "usemtl floor", "f 1/1 2/2 3/3 4/4", "usemtl card"]
    for k in range(12):
        cx, cz = rng.uniform(-2, 2, 2)
        a = rng.uniform(0, np.pi)
        dx, dz = 0.6 * np.cos(a), 0.6 * np.sin(a)
        h = rng.uniform(0.8, 1.6)
        base = 5 + 4 * k
        for px, py, pz in ((cx - dx, 0, cz - dz), (cx + dx, 0, cz + dz),
                           (cx + dx, h, cz + dz), (cx - dx, h, cz - dz)):
            lines.append(f"v {px:.5f} {py:.5f} {pz:.5f}")
        lines.append(f"f {base}/1 {base + 1}/2 {base + 2}/3 {base + 3}/4")
    with open(os.path.join(tmp, "mesh.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.join(tmp, "mesh.obj")


def _mesh_camera():
    return j_types.make_camera(j_types.look_at((0.5, 1.6, -5.5),
                                               (0, 0.5, 0)), 50.0, W, H)


def test_with_texture_mips_matches_jax(tmp_path):
    js = j_obj.load_obj(_mesh_dir(str(tmp_path), cutout=False))
    jm = j_pt.with_texture_mips(js)
    tm = t_pt.with_texture_mips(scene_from_numpy(_fields(js), device="cpu"))
    assert torch.equal(tm.tex_mips, T(np.asarray(jm.tex_mips)))
    assert torch.equal(tm.mat_texel, T(np.asarray(jm.mat_texel)))
    assert (tm.mat_texel > 0).sum() == 2
    bare = scene_from_numpy(_fields(js), device="cpu")._replace(
        textures=None)
    assert t_pt.with_texture_mips(bare).tex_mips is None


def test_sample_alpha_and_cutout_hits_match_jax(tmp_path):
    js = j_obj.load_obj(_mesh_dir(str(tmp_path), cutout=True))
    assert js.alpha_textures is not None
    ts = scene_from_numpy(_fields(js), device="cpu")
    rng = np.random.default_rng(8)
    R = 3000
    o = np.tile(np.float32([0.5, 1.6, -5.5]), (R, 1))
    o[R // 2:] = rng.uniform(-3, 3, (R - R // 2, 3)).astype(np.float32)
    o[R // 2:, 1] = np.abs(o[R // 2:, 1]) + 0.1
    d = (rng.uniform(-2, 2, (R, 3)) * np.float32([1, 0.4, 1])
         - o * np.float32([0.3, 0.5, 0.3])).astype(np.float32)
    d[: R // 2] = (np.float32([0, 0.5, 0]) - o[: R // 2]
                   + rng.normal(0, 0.8, (R // 2, 3)).astype(np.float32))
    jt, jn, jmat, jh, juv, _ = j_pt._closest_hit(js, J(o), J(d), 1e-3, 1e4)
    tt, tn, tmat, th, tuv, _ = t_pt._closest_hit(ts, T(o), T(d), 1e-3, 1e4)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-5)
    ja = np.asarray(j_pt._sample_alpha(js, jmat, jn, juv))
    ta = t_pt._sample_alpha(ts, tmat, tn, tuv).numpy()
    # the nearest texel: equal but where the two uv sit across a texel edge
    assert (np.abs(ta - ja) <= 1e-6).mean() >= 0.995
    cut = np.asarray(jh) & (ja < 0.5)
    assert 0.05 < cut.mean() < 0.6
    want = j_pt._closest_hit_cutout(js, J(o), J(d), 1e-3, 1e4)
    trace_counts = []
    got = t_pt._closest_hit_cutout(ts, T(o), T(d), 1e-3, 1e4,
                                   retraced=trace_counts)
    same = (got[3].numpy() == np.asarray(want[3])) & \
        (got[2].numpy() == np.asarray(want[2]))
    assert same.mean() >= 0.995
    hit = same & np.asarray(want[3])
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit],
                               rtol=1e-5)
    # the first trace cuts the rays whose first hit is clear
    assert 2 <= len(trace_counts) <= 4
    assert trace_counts[0] == int((th.numpy() & (ta < 0.5)).sum())
    assert not bool(got[5])


def _render(js, jcam, **kw):
    ts = scene_from_numpy(_fields(js), device="cpu")
    if js.tex_mips is not None:
        ts = t_pt.with_texture_mips(ts)
    cfg = dict(width=W, height=H, samples=1, bounces=3, has_sky=True,
               gamma_correction=False)
    with jax.disable_jit():
        want = np.asarray(j_pt.render_path_traced(
            js, jcam, JCfg(**cfg), seed=0, interpret=True, **kw))
    draws, _ = _pt_draws(0, 1, 3, W * H)
    with draws.patch(), jax_camera_rays(jcam, JCfg(**cfg), 0, 1):
        got = t_pt.render_path_traced(ts, _camera(jcam), RenderConfig(**cfg),
                                      seed=0, **kw).numpy()
    assert draws.done()
    assert np.isfinite(got).all() and got.std() > 0.05
    near = (np.abs(got - want) <= 1e-4).all(-1)
    assert near.mean() >= 0.995
    np.testing.assert_allclose(got.mean((0, 1)), want.mean((0, 1)),
                               atol=2e-3)
    return got


def test_planets_render_matches_jax():
    js, jcam, _ = j_cat.planets_in_one_weekend(W, H)
    _render(js, jcam)


@pytest.mark.parametrize("kind", ["mips", "cutout"])
def test_mesh_render_matches_jax(tmp_path, kind):
    """The textured mesh with mips (bounce 0 through the binned cast, its
    texcoords from the cast's triangle ids), and the cutout mesh (every
    bounce through the cutout loop)."""
    js = j_obj.load_obj(_mesh_dir(str(tmp_path), cutout=kind == "cutout"))
    if kind == "mips":
        js = j_pt.with_texture_mips(js)
    img = _render(js, _mesh_camera(), primary_impl="auto")
    assert img.shape == (H, W, 3)


def test_foveated_rings_are_their_renders():
    ts, tcam, opts = t_cat.cube_and_spheres(32, 24, device="cpu")
    cfg = RenderConfig(width=32, height=24, bounces=3, samples=3,
                       gamma_correction=True)
    fov = t_pt.render_foveated(ts, tcam, cfg, seed=2, rings=(4, 9),
                               ring_samples=(4, 2, 1),
                               aperture=opts["aperture"], focus=opts["focus"])
    one = cfg.replace(samples=1, gamma_correction=False)
    imgs = [t_pt.render_path_traced(ts, tcam, one, seed=8 + s,
                                    aperture=opts["aperture"],
                                    focus=opts["focus"]) for s in range(4)]
    ys, xs = np.mgrid[:24, :32]
    r = np.sqrt((xs - 16.0) ** 2 + (ys - 12.0) ** 2).astype(np.int32)
    for n, ring in ((1, r > 9), (2, (r > 4) & (r <= 9)), (4, r <= 4)):
        acc = torch.zeros_like(imgs[0])
        for img in imgs[:n]:
            acc = acc + img
        want = torch.sqrt(torch.clamp(acc / n, 0.0, 1.0))
        assert ring.any()
        assert torch.equal(fov[T(ring)], want[T(ring)]), n
    outer = t_pt.render_path_traced(ts, tcam, cfg.replace(samples=1), seed=8,
                                    aperture=opts["aperture"],
                                    focus=opts["focus"])
    assert torch.equal(fov[T(r > 9)], outer[T(r > 9)])
