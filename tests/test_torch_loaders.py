"""gsrt_torch's loaders and builders (`scene.obj`, `scene.ply`, `native`,
`scene.instancing`, `ops.bvh`, `scene.reference_scenes`), held against
the JAX package on files the tests write, on the CPU.

Tolerances: OBJ / MTL scenes, instanced scenes and LBVH builds bit-equal;
a PLY round trip keeps means and SH bit for bit, opacity and Σ to 1e-6;
the native and NumPy decodes give equal means and SH and opacity and
scales within 1e-6 (each takes exp in its own libm). The traversal's
visited-node counts and payloads are equal, and so is t where the leaf
function rounds alike in both packages; on spheres t holds to rtol 1e-4
(XLA contracts the vmapped leaf's quadratic, whose cancellation grows
the last-place difference to 1e-5). Tests of the host library
skip where no C++ compiler builds it, as tests/test_native.py skips.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsrt.ops import bvh as j_bvh
from gsrt.ops.gaussian import quat_scale_to_cov3d as j_cov3d
from gsrt.ops.primitives import ray_sphere as j_ray_sphere
from gsrt.scene import instancing as j_inst
from gsrt.scene import obj as j_obj
from gsrt.scene import primitives_catalog as j_cat
from gsrt.scene import reference_scenes as j_ref
from gsrt.scene.catalog import random_cloud as j_random_cloud

from gsrt_torch import native
from gsrt_torch.interop import cloud_from_numpy, scene_from_numpy
from gsrt_torch.ops import bvh as t_bvh
from gsrt_torch.ops.primitives import ray_sphere as t_ray_sphere
from gsrt_torch.scene import instancing as t_inst
from gsrt_torch.scene import obj as t_obj
from gsrt_torch.scene import ply as t_ply
from gsrt_torch.scene import reference_scenes as t_ref

from test_torch_pathtracer import _fields

J, T = jnp.asarray, torch.as_tensor


def _same_scene(ts, js):
    """Every array of the JAX package's scene equal in the port's."""
    for k, a in _fields(js).items():
        if k == "materials":
            for m, v in a.items():
                assert torch.equal(getattr(ts.materials, m), T(v)), m
            continue
        assert torch.equal(getattr(ts, k), T(a)), k
    for k, v in js._asdict().items():
        if k not in ("materials", "tri_table", "tri_clusters"):
            assert (getattr(ts, k) is None) == (v is None), k
    assert (ts.materials.texture_id is None) == \
        (js.materials.texture_id is None)


def _write_png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


def _obj_files(d, name="quad", alpha=False):
    """A quad with full UVs, a pentagon fanned into 3 triangles, negative
    indices, a textured, an emissive, a glass and a metal material."""
    pytest.importorskip("PIL")
    tex = np.zeros((8, 8, 4 if alpha else 3), np.uint8)
    tex[:, :4, 0] = 255
    tex[:, 4:, 1] = 255
    if alpha:
        tex[..., 3] = 255
        tex[:, :4, 3] = 0
    _write_png(os.path.join(d, f"{name}.png"), tex)
    with open(os.path.join(d, f"{name}.mtl"), "w") as f:
        f.write(f"newmtl tx\nKd 1 1 1\nmap_Kd {name}.png\n"
                + (f"map_d {name}.png\n" if alpha else "")
                + "newmtl lamp\nKe 4 4 3\n"
                + "newmtl glass\nNi 1.5\nillum 7\n"
                + "newmtl steel\nKd 0.7 0.7 0.8\nNs 500\nillum 3\n")
    with open(os.path.join(d, f"{name}.obj"), "w") as f:
        f.write(f"mtllib {name}.mtl\n"
                "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                "usemtl tx\nf 1/1 2/2 3/3 4/4\n"
                "v 2 0 1\nv 3 0 1\nv 3.5 1 1\nv 2.5 2 1\nv 2 1 1\n"
                "usemtl lamp\nf -5 -4 -3 -2 -1\n"
                "usemtl glass\nf 5 6 7\nusemtl steel\nf 6/2 7/3 8/4\n"
                "usemtl\nf 1 3 5\n")
    return os.path.join(d, f"{name}.obj")


@pytest.mark.parametrize("alpha", [False, True])
def test_load_obj_matches_jax(tmp_path, alpha):
    path = _obj_files(str(tmp_path), alpha=alpha)
    xf = np.float32([[0.5, 0, 0, 1], [0, 0.5, 0, 2], [0, 0, 0.5, 3]])
    for transform in (None, xf):
        js = j_obj.load_obj(path, transform=transform)
        ts = t_obj.load_obj(path, transform=transform, device="cpu")
        _same_scene(ts, js)
    assert ts.tri_v0.shape[0] == 8 and ts.textures.shape[1:] == (256, 256, 3)
    assert (ts.alpha_textures is not None) == alpha


def test_load_obj_dir_and_camera_file_match_jax(tmp_path):
    d = str(tmp_path)
    _obj_files(d, "a")
    _obj_files(d, "b", alpha=True)
    _obj_files(d, "c")
    rules = [("b*", (1, (0.9, 0.9, 0.9), 0.1, 1.0)), ("c*", None)]
    js = j_obj.load_obj_dir(d, overrides=rules)
    ts = t_obj.load_obj_dir(d, overrides=rules, device="cpu")
    _same_scene(ts, js)
    assert ts.tri_v0.shape[0] == 16
    with open(os.path.join(d, "view.camera"), "w") as f:
        f.write("1 2 3\n4 5 6\n")
    assert t_obj.load_camera_file(os.path.join(d, "view.camera")) == \
        j_obj.load_camera_file(os.path.join(d, "view.camera"))


def test_reference_scene_on_a_written_tree(tmp_path, monkeypatch):
    """trees_and_grass over a tree the test writes (the reference data
    is absent): its overrides, scale, ground sphere and .camera file."""
    scene_dir = tmp_path / "Scenes" / "TreesAndGrass"
    scene_dir.mkdir(parents=True)
    _obj_files(str(scene_dir), "grass_01")
    _obj_files(str(scene_dir), "tree_02", alpha=True)
    with open(scene_dir / "Camera.camera", "w") as f:
        f.write("2 0.5 0.75 0 0.3 0\n")
    monkeypatch.setattr(j_ref, "REF_ROOT", str(tmp_path))
    monkeypatch.setattr(t_ref, "REF_ROOT", str(tmp_path))
    assert t_ref.reference_data_available()
    js, jcam, jopts = j_ref.trees_and_grass(24, 16)
    ts, tcam, topts = t_ref.trees_and_grass(24, 16, device="cpu")
    _same_scene(ts, js)
    assert topts == jopts and torch.equal(tcam.view, T(np.asarray(jcam.view)))
    assert set(t_ref.REFERENCE_SCENES) == set(j_ref.REFERENCE_SCENES)


def test_reference_tree_absent_by_default():
    if os.environ.get("GSRT_REFERENCE_ROOT"):
        pytest.skip("GSRT_REFERENCE_ROOT names a tree")
    assert not t_ref.reference_data_available()


def _cloud_params(n, seed, sh_k=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32),
            rng.uniform(0.01, 1, (n, 3)).astype(np.float32),
            rng.uniform(0.05, 0.95, n).astype(np.float32),
            rng.normal(size=(n, sh_k, 3)).astype(np.float32))


@pytest.mark.parametrize("use_native", [False, True])
def test_ply_round_trip(tmp_path, monkeypatch, use_native):
    if use_native and not native.available():
        pytest.skip("no C++ compiler builds the host library")
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    means, quats, scales, op, sh = _cloud_params(300, 4)
    path = str(tmp_path / "c.ply")
    t_ply.save_gaussian_ply(path, T(means), quats, scales, op, sh)
    with open(path, "rb") as f:
        mine = f.read()
    from gsrt.scene.ply import save_gaussian_ply as j_save
    j_save(str(tmp_path / "j.ply"), means, quats, scales, op, sh)
    with open(tmp_path / "j.ply", "rb") as f:
        assert f.read() == mine               # the same file, byte for byte
    cloud = t_ply.load_gaussian_ply(path, device="cpu")
    assert torch.equal(cloud.means, T(means)) and torch.equal(cloud.sh, T(sh))
    np.testing.assert_allclose(cloud.opacity.numpy(), op, atol=1e-6)
    want_cov = np.asarray(j_cov3d(J(quats), J(scales)))
    np.testing.assert_allclose(cloud.cov3d.numpy(), want_cov, atol=1e-6)
    low = t_ply.load_gaussian_ply(path, max_sh_degree=1, device="cpu")
    assert torch.equal(low.sh, T(sh[:, :4]))


def test_native_and_numpy_ply_decodes_agree(tmp_path, monkeypatch):
    if not native.available():
        pytest.skip("no C++ compiler builds the host library")
    path = str(tmp_path / "c.ply")
    t_ply.save_gaussian_ply(path, *_cloud_params(5000, 5))
    a = t_ply.load_gaussian_ply(path, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    b = t_ply.load_gaussian_ply(path, device="cpu")
    assert torch.equal(a.means, b.means) and torch.equal(a.sh, b.sh)
    np.testing.assert_allclose(a.opacity.numpy(), b.opacity.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(a.cov3d.numpy(), b.cov3d.numpy(), atol=1e-6)


def test_native_lbvh_matches_jax_native_and_build():
    if not native.available():
        pytest.skip("no C++ compiler builds the host library")
    from gsrt import native as j_native
    rng = np.random.default_rng(1)
    c = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.5, (500, 1)).astype(np.float32)
    got = native.build_lbvh_native(c - r, c + r)
    if j_native.available():
        want = j_native.build_lbvh_native(c - r, c + r)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the same tree as ops.bvh.build_lbvh's
    tb = t_bvh.build_lbvh(T(c - r), T(c + r))
    for k in ("left", "right", "left_leaf", "right_leaf", "leaf_prim"):
        np.testing.assert_array_equal(got[k], getattr(tb, k).numpy(),
                                      err_msg=k)


def test_instantiate_scene_matches_jax():
    """Spheres, axis-aligned and rotated boxes (12 triangles each),
    textured triangles, cylinders and a Mandelbulb, three transforms."""
    b = j_cat._SceneBuilder()
    tex = b.texture(np.ones((8, 8, 3), np.float32),
                    alpha=np.tri(8, dtype=np.float32))
    m = b.material(0, (0.8, 0.2, 0.2), tex_id=tex)
    b.sphere((0, 1, 0), 0.5, m)
    b.box((-1, -2, -3), (1, 2, 3), b.lambertian((0.5, 0.5, 0.5)))
    b.quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), m)
    b.cylinder((1, 0, 0), 0.5, b.light((1, 0.5, 0.2)))
    b.mandelbulb((0, 2, 0), 1.0, m)
    js = b.build()
    uv = jnp.asarray(np.random.default_rng(2).random((2, 2)), jnp.float32)
    js = js._replace(tri_uv0=uv, tri_uv1=uv[::-1], tri_uv2=uv)
    ts = scene_from_numpy(_fields(js), device="cpu")
    xf = [j_inst.make_transform((0, 0, 0)),
          j_inst.make_transform((0, 0, -4), rotate_y_deg=90.0, scale=2.0),
          j_inst.make_transform((5, 1, 0), rotate_y_deg=30.0, scale=0.5)]
    for a, b_ in zip(xf, [t_inst.make_transform((0, 0, 0)),
                          t_inst.make_transform((0, 0, -4), 90.0, 2.0),
                          t_inst.make_transform((5, 1, 0), 30.0, 0.5)]):
        np.testing.assert_array_equal(a, b_)
    want = j_inst.instantiate_scene(js, xf)
    got = t_inst.instantiate_scene(ts, xf)
    _same_scene(got, want)
    assert got.tri_v0.shape[0] == 3 * 2 + 12            # one rotated box
    tilt = np.eye(3, 4, dtype=np.float32)
    tilt[1:3, 1:3] = [[0.8, -0.6], [0.6, 0.8]]
    with pytest.raises(ValueError, match="y axis"):
        t_inst.instantiate_scene(ts, [tilt])


def test_instantiate_cloud_matches_jax():
    jc, _ = j_random_cloud(64, seed=1, width=16, height=16)
    tc = cloud_from_numpy(*(np.asarray(a) for a in jc), device="cpu")
    xf = [t_inst.make_transform((1, 2, 3), 30.0, 2.0),
          t_inst.make_transform((0, 0, 0), -45.0, 0.5)]
    want = j_inst.instantiate_cloud(jc, xf)
    got = t_inst.instantiate_cloud(tc, xf)
    for g, w in zip(got, want):
        assert torch.equal(g, T(np.asarray(w)))


def _spheres(n, seed, extent=10.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    r = rng.uniform(0.1, 0.8, n).astype(np.float32)
    c[:24] = c[0]                              # duplicate Morton codes
    return c, r


def test_build_lbvh_matches_jax():
    c, r = _spheres(300, 3)
    want = j_bvh.build_lbvh(J(c - r[:, None]), J(c + r[:, None]))
    got = t_bvh.build_lbvh(T(c - r[:, None]), T(c + r[:, None]))
    for k in want._fields:
        assert torch.equal(getattr(got, k), T(np.asarray(getattr(want, k)))), k


@pytest.mark.parametrize("leaf", ["spheres", "ids", "any-hit"])
def test_bvh_traverse_matches_jax(leaf):
    """Closest sphere hits (t to rtol 1e-4), and a leaf function whose t is
    a function of the primitive id alone, so both packages take the same
    t bit for bit (closest and any hit): payloads and visited-node counts
    equal in all three."""
    c, r = _spheres(256, 4)
    lo, hi = c - r[:, None], c + r[:, None]
    jb = j_bvh.build_lbvh(J(lo), J(hi))
    tb = t_bvh.build_lbvh(T(lo), T(hi))
    rng = np.random.default_rng(5)
    R = 96
    o = rng.uniform(-15, 15, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[: R // 2] = c[rng.integers(0, 256, R // 2)] - o[: R // 2]  # aimed
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cj, rj, ct, rt = J(c), J(r), T(c), T(r)
    ids_t = (1.0 + 0.25 * (np.arange(256) % 37)).astype(np.float32)

    if leaf == "spheres":
        def j_leaf(prim, oo, dd, t_min, best_t, p):
            t = j_ray_sphere(oo[None], dd[None], cj[prim][None],
                             rj[prim][None], t_min, best_t)[0, 0]
            closer = t < best_t
            return jnp.where(closer, t, best_t), jnp.where(closer, prim, p)

        def t_leaf(prim, oo, dd, t_min, best_t, p):
            t = t_ray_sphere(oo, dd, ct[prim], rt[prim], t_min,
                             best_t[:, None]).diagonal()
            closer = t < best_t
            return (torch.where(closer, t, best_t),
                    torch.where(closer, prim.to(torch.int32), p))
    else:
        def j_leaf(prim, oo, dd, t_min, best_t, p):
            t = J(ids_t)[prim]
            closer = t < best_t
            return jnp.where(closer, t, best_t), jnp.where(closer, prim, p)

        def t_leaf(prim, oo, dd, t_min, best_t, p):
            t = T(ids_t)[prim]
            closer = t < best_t
            return (torch.where(closer, t, best_t),
                    torch.where(closer, prim.to(torch.int32), p))
    kw = dict(any_hit=leaf == "any-hit")
    tmax = 1e4 if leaf == "spheres" else 9.0
    jt, jp, jv = j_bvh.bvh_traverse(jb, J(o), J(d), 1e-3, tmax, j_leaf,
                                    jnp.int32(-1), **kw)
    tt, tp, tv = t_bvh.bvh_traverse(tb, T(o), T(d), 1e-3, tmax, t_leaf,
                                    torch.tensor(-1, dtype=torch.int32), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert (tp.numpy() >= 0).mean() > 0.2
    if leaf == "spheres":
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4)
    else:
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tv.float().mean() < 2 * 256
