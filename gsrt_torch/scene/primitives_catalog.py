"""Path-tracer scenes (counterpart of `gsrt.scene.primitives_catalog`):
the scene builder and the catalog's scenes — RTIOW and its textured
planets, the Cornell box, cube and spheres, the cube and cylinder fields,
the Mandelbulb, the simple test and `mirror_in_gaussians`, a scene with
splats. The NumPy draws are the JAX package's, so the scenes' arrays are
bit-equal to its. Scenes are built on CUDA unless device="cpu".
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gsrt_torch.core.types import (Materials, look_at, make_camera,
                                   resolve_device)
from gsrt_torch.models.path_tracer import PrimitiveScene

# the reference renderer's source tree, where GSRT_REFERENCE_ROOT names
# one: cube_and_spheres reads its OBJ cube from there
REF_ROOT = os.environ.get("GSRT_REFERENCE_ROOT", "")


class _SceneBuilder:
    """Collects spheres, boxes, cylinders, Mandelbulbs, triangles,
    materials and textures; `build` makes the scene."""

    def __init__(self):
        self.sph = []       # (center, radius, mat)
        self.boxes = []     # (bmin, bmax, mat)
        self.cyls = []      # (center, radius, half_h, mat)
        self.bulbs = []     # (center, radius, mat)
        self.tris = []      # (v0, v1, v2, mat)
        self.mats = []      # (model, diffuse, fuzz, refr, tex_id)
        self.textures = []  # [TH, TW, 3] arrays of one size
        self.alphas = []    # [TH, TW] cutout masks, one a texture

    def texture(self, img, alpha=None) -> int:
        img = np.asarray(img, np.float32)
        self.textures.append(img)
        self.alphas.append(np.ones(img.shape[:2], np.float32)
                           if alpha is None else np.asarray(alpha, np.float32))
        return len(self.textures) - 1

    def material(self, model, diffuse=(0, 0, 0), fuzz=0.0, refr=1.0,
                 tex_id=-1) -> int:
        self.mats.append((model, diffuse, fuzz, refr, tex_id))
        return len(self.mats) - 1

    def lambertian(self, rgb):
        return self.material(Materials.LAMBERTIAN, rgb)

    def metallic(self, rgb, fuzz):
        return self.material(Materials.METALLIC, rgb, fuzz=fuzz)

    def dielectric(self, refr):
        return self.material(Materials.DIELECTRIC, (1, 1, 1), refr=refr)

    def light(self, rgb):
        return self.material(Materials.DIFFUSE_LIGHT, rgb)

    def sphere(self, center, radius, mat):
        self.sph.append((center, radius, mat))

    def box(self, bmin, bmax, mat):
        self.boxes.append((bmin, bmax, mat))

    def cube(self, center, half, mat):
        """The AABB center ± half."""
        c = np.asarray(center, np.float32)
        self.boxes.append((c - half, c + half, mat))

    def cylinder(self, center, radius, mat, half_h=None):
        """A capped y-axis cylinder, half-height = radius by default."""
        self.cyls.append((center, radius,
                          radius if half_h is None else half_h, mat))

    def mandelbulb(self, center, radius, mat):
        self.bulbs.append((center, radius, mat))

    def quad(self, a, b, c, d, mat):
        self.tris.append((a, b, c, mat))
        self.tris.append((a, c, d, mat))

    def tri(self, a, b, c, mat):
        self.tris.append((a, b, c, mat))

    def build(self, device=None) -> PrimitiveScene:
        """The scene; textures, and cutout masks where some texel is below
        1, when any texture was added; cylinder and Mandelbulb fields when
        any was."""
        dev = resolve_device(device)

        def arr(x, shape, dtype=np.float32):
            return torch.as_tensor(np.asarray(x, dtype).reshape(shape),
                                   device=dev)

        S, B, T = len(self.sph), len(self.boxes), len(self.tris)
        C, M = len(self.cyls), len(self.bulbs)
        mats = Materials(
            model=arr([m[0] for m in self.mats], (-1,), np.int32),
            diffuse=arr([m[1] for m in self.mats], (-1, 3)),
            fuzziness=arr([m[2] for m in self.mats], (-1,)),
            refraction_index=arr([m[3] for m in self.mats], (-1,)),
            texture_id=arr([m[4] for m in self.mats], (-1,), np.int32))
        textures = (torch.as_tensor(np.stack(self.textures), device=dev)
                    if self.textures else None)
        has_cutout = any((a < 1.0).any() for a in self.alphas)
        alphas = (torch.as_tensor(np.stack(self.alphas), device=dev)
                  if has_cutout else None)
        cyl = dict(
            cyl_center=arr([c[0] for c in self.cyls], (C, 3)),
            cyl_radius=arr([c[1] for c in self.cyls], (C,)),
            cyl_half_h=arr([c[2] for c in self.cyls], (C,)),
            cyl_mat=arr([c[3] for c in self.cyls], (C,), np.int32),
        ) if C else {}
        mnd = dict(
            mnd_center=arr([m[0] for m in self.bulbs], (M, 3)),
            mnd_radius=arr([m[1] for m in self.bulbs], (M,)),
            mnd_mat=arr([m[2] for m in self.bulbs], (M,), np.int32),
        ) if M else {}
        return PrimitiveScene(
            textures=textures, alpha_textures=alphas, **cyl, **mnd,
            sph_center=arr([s[0] for s in self.sph], (S, 3)),
            sph_radius=arr([s[1] for s in self.sph], (S,)),
            sph_mat=arr([s[2] for s in self.sph], (S,), np.int32),
            box_min=arr([b[0] for b in self.boxes], (B, 3)),
            box_max=arr([b[1] for b in self.boxes], (B, 3)),
            box_mat=arr([b[2] for b in self.boxes], (B,), np.int32),
            tri_v0=arr([t[0] for t in self.tris], (T, 3)),
            tri_v1=arr([t[1] for t in self.tris], (T, 3)),
            tri_v2=arr([t[2] for t in self.tris], (T, 3)),
            tri_mat=arr([t[3] for t in self.tris], (T,), np.int32),
            materials=mats)


def _common_grid(b: _SceneBuilder, rng):
    """The RTIOW ground sphere and 22×22 grid of small spheres (diffuse,
    metal, glass at 0.8 / 0.15 / 0.05), without the three large ones."""
    b.sphere((0, -1000, 0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    for i in range(-11, 11):
        for j in range(-11, 11):
            choose = rng.random()
            cy = j + 0.9 * rng.random()
            cx = i + 0.9 * rng.random()
            center = np.array([cx, 0.2, cy])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) > 0.9:
                if choose < 0.8:
                    rgb = rng.random(3) * rng.random(3)
                    b.sphere(center, 0.2, b.lambertian(rgb))
                elif choose < 0.95:
                    fuzz = 0.5 * rng.random()
                    rgb = 0.5 * (1 + rng.random(3))
                    b.sphere(center, 0.2, b.metallic(rgb, fuzz))
                else:
                    b.sphere(center, 0.2, b.dielectric(1.5))


def _rtiow_camera(width, height, device):
    return make_camera(look_at((13, 2, 3), (0, 0, 0)), 20.0, width, height,
                       device=device)


def ray_tracing_in_one_weekend(width=640, height=480, seed=42, device=None):
    """RTIOW's final scene: the common grid and three large spheres
    (glass, brown, metal); camera at (13, 2, 3), 20°, aperture 0.1.
    Returns (scene, camera, options)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b = _SceneBuilder()
    _common_grid(b, rng)
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metallic((0.7, 0.6, 0.5), 0.0))
    return b.build(dev), _rtiow_camera(width, height, dev), dict(
        aperture=0.1, focus=10.0, has_sky=True, gamma=True)


def cornell_box(width=512, height=512, with_boxes=True, device=None):
    """The Cornell box of the JAX package's catalog: 555-unit room (green
    left, red right, white floor, ceiling and back), a ceiling light of
    emission 15, two axis-aligned boxes; camera at (278, 278, 800), 40°,
    no sky. Returns (scene, camera, options)."""
    s = 555.0
    b = _SceneBuilder()
    green = b.lambertian((0.12, 0.45, 0.15))
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    light = b.light((15.0, 15.0, 15.0))

    l0, l1, l2, l3 = (0, 0, 0), (0, 0, -s), (0, s, -s), (0, s, 0)
    r0, r1, r2, r3 = (s, 0, 0), (s, 0, -s), (s, s, -s), (s, s, 0)
    b.quad(l0, l1, l2, l3, green)          # left
    b.quad(r2, r1, r0, r3, red)           # right
    b.quad(l1, r1, r2, l2, white)          # back
    b.quad(l0, r0, r1, l1, white)          # floor
    b.quad(l2, r2, r3, l3, white)          # ceiling
    x0, x1 = s * 213 / 555, s * 343 / 555
    z0, z1 = -s + s * 332 / 555, -s + s * 227 / 555
    y1 = s * 0.998
    b.quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), light)
    if with_boxes:
        b.box((555 - 130 - 165, 0, -65 - 165), (555 - 130, 165, -65), white)
        b.box((555 - 265 - 165, 0, -295 - 165), (555 - 265, 330, -295), white)
    camera = make_camera(look_at((278, 278, 800), (278, 278, 0)), 40.0,
                         width, height, device=device)
    return b.build(device), camera, dict(aperture=0.0, focus=10.0,
                                         has_sky=False, gamma=True)


def _procedural_earth(th=128, tw=256):
    """A procedural lat-long planet texture (oceans, banded land, ice)."""
    v, u = np.mgrid[0:th, 0:tw].astype(np.float32)
    u /= tw
    v /= th
    lat = (v - 0.5) * np.pi
    land = (np.sin(u * 12.6 + np.sin(v * 9.4) * 2.0)
            + 0.5 * np.sin(u * 31.4 + v * 17.0)
            + 0.25 * np.sin(u * 63.0 - v * 40.0))
    img = np.where((land < 0.3)[..., None], np.array([0.05, 0.15, 0.45]),
                   np.array([0.15, 0.45, 0.15]))
    img = np.where((np.abs(lat) > 1.25)[..., None],
                   np.array([0.9, 0.92, 0.95]), img)
    return img.astype(np.float32)


def _procedural_planet(hi_rgb, lo_rgb, th=128, tw=256):
    """A two-tone banded lat-long texture."""
    v, u = np.mgrid[0:th, 0:tw].astype(np.float32)
    u /= tw
    v /= th
    bands = (np.sin(u * 18.8 + np.sin(v * 11.0) * 1.5)
             + 0.5 * np.sin(u * 47.1 - v * 23.0))
    img = np.where((bands < 0.2)[..., None], np.asarray(lo_rgb, np.float32),
                   np.asarray(hi_rgb, np.float32))
    return img.astype(np.float32)


def planets_in_one_weekend(width=640, height=480, seed=42, device=None):
    """The common grid with three textured planets: a fuzz-0.1 metal
    earth at (0, 1, 0), a Lambertian mars at (-4, 1, 0), a fuzz-0 metal
    moon at (4, 1, 0), their textures procedural. RTIOW's camera."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b = _SceneBuilder()
    tex_earth = b.texture(_procedural_earth())
    tex_mars = b.texture(_procedural_planet((0.55, 0.25, 0.12),
                                            (0.35, 0.15, 0.08)))
    tex_moon = b.texture(_procedural_planet((0.65, 0.65, 0.62),
                                            (0.42, 0.42, 0.40)))
    _common_grid(b, rng)
    b.sphere((0, 1, 0), 1.0, b.material(Materials.METALLIC, (1, 1, 1),
                                        fuzz=0.1, tex_id=tex_earth))
    b.sphere((-4, 1, 0), 1.0, b.material(Materials.LAMBERTIAN, (1, 1, 1),
                                         tex_id=tex_mars))
    b.sphere((4, 1, 0), 1.0, b.material(Materials.METALLIC, (1, 1, 1),
                                        fuzz=0.0, tex_id=tex_moon))
    return b.build(dev), _rtiow_camera(width, height, dev), dict(
        aperture=0.1, focus=10.0, has_sky=True, gamma=True)


def cube_and_spheres(width=256, height=256, device=None):
    """Three spheres (fuzz-0.2 metal, glass, a Lambertian textured with
    the procedural earth) and the reference tree's cube_multi.obj where
    REF_ROOT holds it, else a unit box; camera at (0, 0, 2), 90°,
    aperture 0.05."""
    dev = resolve_device(device)
    b = _SceneBuilder()
    tex_earth = b.texture(_procedural_earth())
    b.sphere((1, 0, 0), 0.5, b.metallic((0.7, 0.5, 0.8), 0.2))
    b.sphere((-1, 0, 0), 0.5, b.dielectric(1.5))
    b.sphere((0, 1, 0), 0.5, b.material(Materials.LAMBERTIAN, (1, 1, 1),
                                        tex_id=tex_earth))
    obj_path = os.path.join(REF_ROOT, "assets", "models", "cube_multi.obj")
    if REF_ROOT and os.path.exists(obj_path):
        from gsrt_torch.scene.obj import load_obj
        cube = load_obj(obj_path, device="cpu")
        base = len(b.mats)
        mm = cube.materials
        for k in range(int(mm.model.shape[0])):
            b.material(int(mm.model[k]),
                       tuple(mm.diffuse[k].numpy().astype(np.float32)),
                       fuzz=float(mm.fuzziness[k]),
                       refr=float(mm.refraction_index[k]))
        v0, v1, v2 = (a.numpy() for a in (cube.tri_v0, cube.tri_v1,
                                           cube.tri_v2))
        vm = cube.tri_mat.numpy()
        for t in range(v0.shape[0]):
            b.tri(v0[t], v1[t], v2[t], base + int(vm[t]))
    else:
        b.box((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5),
              b.lambertian((0.8, 0.6, 0.2)))
    camera = make_camera(look_at((0, 0, 2), (0, 0, 0)), 90.0, width, height,
                         device=dev)
    return b.build(dev), camera, dict(aperture=0.05, focus=2.0,
                                      has_sky=True, gamma=False)


def _grid_centers(rng, grid):
    """The cells of a 2·grid square field: the material draw, then the
    two jitter draws; a cell spawns where its centre clears (4, 0.2, 0)
    by 0.9."""
    for i in range(-grid, grid):
        for j in range(-grid, grid):
            choose = rng.random()
            cy = j + 0.9 * rng.random()
            cx = i + 0.9 * rng.random()
            center = np.array([cx, 0.2, cy])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) > 0.9:
                yield choose, center


def cubes_and_common_scene(width=640, height=480, seed=42, grid=30,
                           device=None):
    """The common grid and a (2·grid)² field of 0.2-half-extent cubes,
    diffuse / metal / glass at 0.8 / 0.15 / 0.05 (grid 30: 3,600 cells).
    RTIOW's camera."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b = _SceneBuilder()
    _common_grid(b, rng)
    for choose, center in _grid_centers(rng, grid):
        if choose < 0.8:
            b.cube(center, 0.2, b.lambertian(rng.random(3) * rng.random(3)))
        elif choose < 0.95:
            fuzz = 0.5 * rng.random()
            b.cube(center, 0.2, b.metallic(0.5 * (1 + rng.random(3)), fuzz))
        else:
            b.cube(center, 0.2, b.dielectric(1.5))
    return b.build(dev), _rtiow_camera(width, height, dev), dict(
        aperture=0.1, focus=10.0, has_sky=True, gamma=True)


def cylinder_cubes_common_scene(width=640, height=480, seed=42, grid=30,
                                device=None):
    """The common grid and a (2·grid)² field, half cubes (as in
    `cubes_and_common_scene`), half emissive cylinders of radius and
    half-height 0.2. RTIOW's camera."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b = _SceneBuilder()
    _common_grid(b, rng)
    for i in range(-grid, grid):
        for j in range(-grid, grid):
            kind = rng.random()
            choose = rng.random()
            cy = j + 0.9 * rng.random()
            cx = i + 0.9 * rng.random()
            center = np.array([cx, 0.2, cy])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if kind <= 0.5:
                if choose < 0.8:
                    b.cube(center, 0.2,
                           b.lambertian(rng.random(3) * rng.random(3)))
                elif choose < 0.95:
                    fuzz = 0.5 * rng.random()
                    b.cube(center, 0.2,
                           b.metallic(0.5 * (1 + rng.random(3)), fuzz))
                else:
                    b.cube(center, 0.2, b.dielectric(1.5))
            else:
                rgb = (rng.random(3) * rng.random(3) if choose < 0.8
                       else 0.5 * (1 + rng.random(3)))
                b.cylinder(center, 0.2, b.light(rgb))
    return b.build(dev), _rtiow_camera(width, height, dev), dict(
        aperture=0.1, focus=10.0, has_sky=True, gamma=True)


def mandelbulb_scene(width=640, height=480, seed=42, device=None):
    """The common grid and a radius-1.25 power-8 Mandelbulb at (0, 2, 0),
    Lambertian (0.5, 0.7, 1.0); camera at (0, 2.5, 3) facing -z, 90°."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b = _SceneBuilder()
    _common_grid(b, rng)
    b.mandelbulb((0, 2, 0), 1.25, b.lambertian((0.5, 0.7, 1.0)))
    camera = make_camera(look_at((0, 2.5, 3), (0, 2.5, 0)), 90.0, width,
                         height, device=dev)
    return b.build(dev), camera, dict(aperture=0.05, focus=2.0, has_sky=True,
                                      gamma=True)


def simple_test(width=512, height=512, device=None):
    """A 555-unit green back panel and the Cornell box's ceiling light;
    no sky; the Cornell box's camera."""
    dev = resolve_device(device)
    s = 555.0
    b = _SceneBuilder()
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.light((15.0, 15.0, 15.0))
    b.quad((0, 0, -s), (s, 0, -s), (s, s, -s), (0, s, -s), green)
    x0, x1 = s * 213 / 555, s * 343 / 555
    z0, z1 = s * (-555 + 332) / 555, s * (-555 + 227) / 555
    y1 = s * 0.998
    b.quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), light)
    camera = make_camera(look_at((278, 278, 800), (278, 278, 0)), 40.0,
                         width, height, device=dev)
    return b.build(dev), camera, dict(aperture=0.0, focus=10.0,
                                      has_sky=False, gamma=True)


def mirror_in_gaussians(width=128, height=128, n_splats=60, seed=7,
                        device=None):
    """A fuzz-0 metal sphere and a ground plane inside a cloud of splats:
    the splats must show directly and in the mirror. The same NumPy draws
    as the JAX package's scene. Returns (scene, cloud, camera, options)."""
    from gsrt_torch.scene.catalog import _cloud_from_params
    dev = resolve_device(device)
    b = _SceneBuilder()
    b.sphere((0.0, 1.0, 0.0), 1.0, b.metallic((0.9, 0.9, 0.9), 0.0))
    b.quad((-20, 0, -20), (20, 0, -20), (20, 0, 20), (-20, 0, 20),
           b.lambertian((0.5, 0.5, 0.5)))
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3.0, 3.0, (n_splats, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(0.5, 3.0, n_splats)  # above the floor
    quats = rng.normal(size=(n_splats, 4)).astype(np.float32)
    scales = rng.uniform(0.08, 0.25, (n_splats, 3)).astype(np.float32)
    opac = rng.uniform(0.4, 0.9, n_splats).astype(np.float32)
    rgb = rng.uniform(0.2, 1.0, (n_splats, 3)).astype(np.float32)
    cloud = _cloud_from_params(centers, quats, scales, opac, rgb, dev)
    camera = make_camera(look_at((0, 1.5, 6.0), (0, 1.0, 0.0)), 45.0,
                         width, height, device=dev)
    return b.build(dev), cloud, camera, dict(aperture=0.0, focus=6.0,
                                             has_sky=True, gamma=False)
