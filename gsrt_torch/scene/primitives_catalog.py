"""Triangle, sphere and box scenes for the path tracer (counterpart of
`gsrt.scene.primitives_catalog`: the scene builder without textures, the
Cornell box, and `mirror_in_gaussians`, a scene with splats). Scenes are
built on CUDA unless device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from gsrt_torch.core.types import (Materials, look_at, make_camera,
                                   resolve_device)
from gsrt_torch.models.path_tracer import PrimitiveScene


class _SceneBuilder:
    """Collects spheres, boxes, triangles and materials; `build` makes the
    scene. Textures, cylinders and Mandelbulbs are not ported yet."""

    def __init__(self):
        self.sph = []       # (center, radius, mat)
        self.boxes = []     # (bmin, bmax, mat)
        self.tris = []      # (v0, v1, v2, mat)
        self.mats = []      # (model, diffuse, fuzz, refr)

    def material(self, model, diffuse=(0, 0, 0), fuzz=0.0,
                 refr=1.0) -> int:
        self.mats.append((model, diffuse, fuzz, refr))
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

    def quad(self, a, b, c, d, mat):
        self.tris.append((a, b, c, mat))
        self.tris.append((a, c, d, mat))

    def tri(self, a, b, c, mat):
        self.tris.append((a, b, c, mat))

    def build(self, device=None) -> PrimitiveScene:
        dev = resolve_device(device)

        def arr(x, shape, dtype=np.float32):
            return torch.as_tensor(np.asarray(x, dtype).reshape(shape),
                                   device=dev)

        S, B, T = len(self.sph), len(self.boxes), len(self.tris)
        mats = Materials(
            model=arr([m[0] for m in self.mats], (-1,), np.int32),
            diffuse=arr([m[1] for m in self.mats], (-1, 3)),
            fuzziness=arr([m[2] for m in self.mats], (-1,)),
            refraction_index=arr([m[3] for m in self.mats], (-1,)),
            texture_id=arr([-1] * len(self.mats), (-1,), np.int32))
        return PrimitiveScene(
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
