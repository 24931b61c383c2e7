"""The triangle scene of the path-tracing cells, made from `scene_seed`:
a seeded stand-in for LumiBench's Bathroom with its triangle count.

A closed room, 3.0 m wide (x), 2.5 m high (y, up) and 2.6 m deep (z),
whose walls, floor and ceiling are grids, holds tessellated fixtures:
a bath (box) under a glass screen (a dielectric pane, refractive index
1.5), a basin (ellipsoid) on a pedestal under a mirror (metal, fuzz 0),
polished taps and a towel rail (metal, fuzz 0.1), a toilet (ellipsoid
bowl, torus seat, box tank), a cabinet, a towel, a towel ring, a shelf of
bottles, pipes, screws, and a skirting strip that takes whatever count is
left, so the scene has exactly the triangles asked for. One emissive
panel under the ceiling lights it; there is no sky, so no path leaves.
Every fixture's tessellation scales with one factor, found by bisection,
so a test can build a few-thousand-triangle room of the same structure.
Edges run from ~0.5 m (wall cells) to under a millimetre (screw and tap
facets) at the full count.

Triangle normals are geometric (the scene has no vertex normals) and the
renderers face them towards the ray; the triangle winding carries no
meaning. The camera is inside the room, 40 degrees of vertical field of
view, facing the mirror over the basin.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark import scene

# material models (gsrt_torch.core.types.Materials' constants)
LAMBERTIAN, METALLIC, DIELECTRIC, DIFFUSE_LIGHT = 0, 1, 2, 4

# name: (model, albedo or emission, fuzz, refractive index)
MATERIALS = {
    "wall": (LAMBERTIAN, (0.80, 0.78, 0.74), 0.0, 1.0),
    "floor": (LAMBERTIAN, (0.45, 0.42, 0.40), 0.0, 1.0),
    "ceiling": (LAMBERTIAN, (0.85, 0.85, 0.85), 0.0, 1.0),
    "ceramic": (LAMBERTIAN, (0.90, 0.90, 0.88), 0.0, 1.0),
    "wood": (LAMBERTIAN, (0.50, 0.32, 0.18), 0.0, 1.0),
    "towel": (LAMBERTIAN, (0.20, 0.40, 0.65), 0.0, 1.0),
    "light": (DIFFUSE_LIGHT, (10.0, 9.5, 9.0), 0.0, 1.0),
    "mirror": (METALLIC, (0.95, 0.95, 0.95), 0.0, 1.0),
    "chrome": (METALLIC, (0.85, 0.85, 0.85), 0.1, 1.0),
    "glass": (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
}
MAT_ID = {k: i for i, k in enumerate(MATERIALS)}

ROOM_LO = np.array([-1.5, 0.0, -1.3])
ROOM_HI = np.array([1.5, 2.5, 1.3])
EYE, TARGET, FOV_DEG = (-0.2, 1.55, 1.15), (-0.35, 1.35, -1.3), 40.0


@dataclass
class TriScene:
    """Triangles as float32 [N, 3] corners, int32 [N] material ids, the
    material table as NumPy arrays, and the camera."""
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    mat: np.ndarray
    materials: dict
    view: scene.View

    @property
    def n(self) -> int:
        return self.v0.shape[0]

    def fields(self) -> dict:
        """The scene as `gsrt_torch.interop.scene_from_numpy` takes it:
        triangles alone, no spheres or boxes."""
        none3 = np.zeros((0, 3), np.float32)
        return dict(sph_center=none3, sph_radius=np.zeros(0, np.float32),
                    sph_mat=np.zeros(0, np.int32), box_min=none3,
                    box_max=none3, box_mat=np.zeros(0, np.int32),
                    tri_v0=self.v0, tri_v1=self.v1, tri_v2=self.v2,
                    tri_mat=self.mat, materials=self.materials)


# --- tessellations: each returns [n, 3, 3] corners (float64) ---

def _quads(P):
    """Two triangles per cell of a [nu + 1, nv + 1, 3] vertex grid."""
    a, b = P[:-1, :-1], P[1:, :-1]
    c, d = P[1:, 1:], P[:-1, 1:]
    t = np.concatenate([np.stack([a, b, c], -2), np.stack([a, c, d], -2)])
    return t.reshape(-1, 3, 3)


def _grid(o, u, v, nu, nv):
    """The parallelogram o + [0, 1]·u + [0, 1]·v in nu × nv cells."""
    s = np.linspace(0.0, 1.0, nu + 1)[:, None, None]
    r = np.linspace(0.0, 1.0, nv + 1)[None, :, None]
    P = np.asarray(o) + s * np.asarray(u) + r * np.asarray(v)
    return _quads(P)


def _box(lo, hi, k):
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    e = np.diag(hi - lo)
    out = []
    for ax in range(3):
        u, v = e[(ax + 1) % 3], e[(ax + 2) % 3]
        for side in (lo, lo + e[ax]):
            o = lo.copy()
            o[ax] = side[ax]
            out.append(_grid(o, u, v, k, k))
    return np.concatenate(out)


def _frame(axis):
    """An orthonormal (u, v, w) with w along `axis` (0, 1 or 2)."""
    w = np.eye(3)[axis]
    return np.eye(3)[(axis + 1) % 3], np.eye(3)[(axis + 2) % 3], w


def _revolve(center, axis, ring, nu):
    """A surface of revolution: ring [m, 2] of (radius, height) points
    swept round `axis` in nu segments → [nu + 1, m, 3] vertices."""
    u, v, w = _frame(axis)
    a = np.linspace(0.0, 2 * np.pi, nu + 1)[:, None, None]
    r, h = ring[None, :, 0:1], ring[None, :, 1:2]
    return np.asarray(center) + r * (np.cos(a) * u + np.sin(a) * v) + h * w


def _fan(center, axis, radius, h, nu):
    u, v, w = _frame(axis)
    a = np.linspace(0.0, 2 * np.pi, nu + 1)
    rim = (np.asarray(center) + h * w + radius
           * (np.cos(a)[:, None] * u + np.sin(a)[:, None] * v))
    c = np.broadcast_to(np.asarray(center) + h * w, (nu, 3))
    return np.stack([c, rim[:-1], rim[1:]], 1)


def _cylinder(center, axis, radius, half_h, nu, nh):
    ring = np.stack([np.full(nh + 1, radius),
                     np.linspace(-half_h, half_h, nh + 1)], 1)
    side = _quads(_revolve(center, axis, ring, nu))
    return np.concatenate([side, _fan(center, axis, radius, -half_h, nu),
                           _fan(center, axis, radius, half_h, nu)])


def _ellipsoid(center, radii, nu, nv):
    """A UV ellipsoid (axis y): quads between latitude rings, fans at the
    poles: 2·nu·(nv − 1) triangles."""
    th = np.linspace(0.0, np.pi, nv + 1)
    ring = np.stack([np.sin(th), -np.cos(th)], 1)
    P = _revolve((0.0, 0.0, 0.0), 1, ring, nu)
    P = np.asarray(center) + P * np.asarray(radii)
    body = _quads(P[:, 1:-1]) if nv > 2 else np.zeros((0, 3, 3))
    south = np.stack([P[:-1, 0], P[1:, 1], P[:-1, 1]], 1)
    north = np.stack([P[:-1, -1], P[:-1, -2], P[1:, -2]], 1)
    return np.concatenate([body, south, north])


def _torus(center, axis, R, r, nu, nv):
    b = np.linspace(0.0, 2 * np.pi, nv + 1)
    ring = np.stack([R + r * np.cos(b), r * np.sin(b)], 1)
    return _quads(_revolve(center, axis, ring, nu))


_COUNT = {
    "grid": lambda nu, nv: 2 * nu * nv,
    "box": lambda k: 12 * k * k,
    "cyl": lambda nu, nh: 2 * nu * nh + 2 * nu,
    "ell": lambda nu, nv: 2 * nu * (nv - 1),
    "torus": lambda nu, nv: 2 * nu * nv,
}
_MAKE = {"grid": _grid, "box": _box, "cyl": _cylinder, "ell": _ellipsoid,
         "torus": _torus}
_LEAST = {"grid": (1, 1), "box": (1,), "cyl": (3, 1), "ell": (3, 2),
          "torus": (3, 3)}


def _parts(rng: np.random.Generator) -> list:
    """(kind, geometry args, full-count resolution, material) of every
    part but the skirting strip. The full-count resolutions put the
    scene's 359,309 triangles mostly in the fixtures, as a modelled
    bathroom has them."""
    lo, hi = ROOM_LO, ROOM_HI
    sx, sy, sz = hi - lo
    P = [
        # the room: floor tiles, ceiling, four walls
        ("grid", (lo, (sx, 0, 0), (0, 0, sz)), (60, 52), "floor"),
        ("grid", ((lo[0], hi[1], lo[2]), (sx, 0, 0), (0, 0, sz)), (6, 5),
         "ceiling"),
        ("grid", (lo, (sx, 0, 0), (0, sy, 0)), (24, 20), "wall"),
        ("grid", ((lo[0], lo[1], hi[2]), (sx, 0, 0), (0, sy, 0)), (6, 5),
         "wall"),
        ("grid", (lo, (0, 0, sz), (0, sy, 0)), (20, 20), "wall"),
        ("grid", ((hi[0], lo[1], lo[2]), (0, 0, sz), (0, sy, 0)), (20, 20),
         "wall"),
        # light, mirror, glass screen
        ("grid", ((-0.6, 2.49, -0.4), (1.2, 0, 0), (0, 0, 0.8)), (12, 8),
         "light"),
        ("grid", ((-0.9, 1.05, -1.29), (1.0, 0, 0), (0, 0.9, 0)), (40, 36),
         "mirror"),
        ("grid", ((0.45, 0.55, -0.6), (0.8, 0, 0), (0, 1.45, 0)), (32, 58),
         "glass"),
        # bath, basin, pedestal, taps
        ("box", ((0.41, 0.001, -1.29), (1.49, 0.55, -0.55)), (48,),
         "ceramic"),
        ("ell", ((-0.4, 0.85, -1.05), (0.28, 0.12, 0.2)), (200, 100),
         "ceramic"),
        ("cyl", ((-0.4, 0.385, -1.1), 1, 0.07, 0.38), (128, 64),
         "ceramic"),
        ("cyl", ((-0.4, 1.02, -1.22), 1, 0.015, 0.06), (96, 32), "chrome"),
        ("torus", ((-0.55, 0.98, -1.2), 1, 0.025, 0.006), (128, 48),
         "chrome"),
        ("torus", ((-0.25, 0.98, -1.2), 1, 0.025, 0.006), (128, 48),
         "chrome"),
        # toilet: tank, bowl, seat
        ("box", ((-1.49, 0.4, 0.1), (-1.32, 0.85, 0.55)), (30,),
         "ceramic"),
        ("ell", ((-1.05, 0.3, 0.33), (0.25, 0.2, 0.18)), (200, 100),
         "ceramic"),
        ("torus", ((-1.05, 0.52, 0.33), 1, 0.18, 0.025), (256, 64),
         "ceramic"),
        # cabinet, towel rail and its brackets, towel, towel ring
        ("box", ((1.2, 0.002, 0.2), (1.49, 0.8, 0.9)), (24,), "wood"),
        ("cyl", ((1.44, 1.2, 0.55), 2, 0.012, 0.3), (96, 48), "chrome"),
        ("cyl", ((1.47, 1.2, 0.27), 0, 0.008, 0.03), (32, 8), "chrome"),
        ("cyl", ((1.47, 1.2, 0.83), 0, 0.008, 0.03), (32, 8), "chrome"),
        ("box", ((1.40, 0.7, 0.3), (1.43, 1.19, 0.8)), (16,), "towel"),
        ("torus", ((-1.45, 1.3, -0.5), 0, 0.09, 0.007), (256, 32),
         "chrome"),
        # shelf, pipes under the basin
        ("box", ((-1.49, 1.55, -1.2), (-1.32, 1.58, -0.6)), (12,), "wood"),
        ("cyl", ((-0.4, 0.5, -1.25), 1, 0.02, 0.25), (64, 32), "chrome"),
        ("cyl", ((-0.25, 0.3, -1.25), 1, 0.02, 0.3), (64, 32), "chrome"),
    ]
    # bottles on the shelf, screws on the mirror, rail and cabinet
    for x in rng.uniform(-1.47, -1.36, 5):
        z = float(rng.uniform(-1.15, -0.65))
        h = float(rng.uniform(0.06, 0.11))
        P.append(("cyl", ((x, 1.581 + h, z), 1, 0.02, h), (48, 24),
                  "ceramic"))
        P.append(("ell", ((x, 1.581 + 2 * h + 0.01, z), (0.012,) * 3),
                  (24, 12), "chrome"))
    screws = [(-0.88, 1.07, -1.285), (0.08, 1.07, -1.285),
              (-0.88, 1.93, -1.285), (0.08, 1.93, -1.285)]
    screws += [(1.49, 1.2 + dy, z) for z in (0.27, 0.83)
               for dy in (-0.02, 0.02)]
    screws += [tuple(p) for p in np.stack([
        np.full(24, 1.198), rng.uniform(0.05, 0.75, 24),
        rng.uniform(0.25, 0.85, 24)], 1)]
    for c in screws:
        P.append(("ell", (c, (0.003,) * 3), (16, 8), "chrome"))
    return P


def _res(kind, full, f):
    return tuple(max(m, int(round(r * f)))
                 for r, m in zip(full, _LEAST[kind]))


def _count(parts, f) -> int:
    return sum(_COUNT[k](*_res(k, full, f)) for k, _, full, _ in parts)


def _skirting(n: int):
    """n triangles of a strip 8 cm high round the floor, 1 cm off the
    walls."""
    lo, hi = ROOM_LO + 0.01, ROOM_HI - 0.01
    corners = np.array([(lo[0], lo[2]), (hi[0], lo[2]), (hi[0], hi[2]),
                        (lo[0], hi[2]), (lo[0], lo[2])])
    seg = np.linalg.norm(np.diff(corners, axis=0), axis=1)
    k = (n + 1) // 2                      # quads; an odd n halves one
    s = np.linspace(0.0, seg.sum(), k + 1)
    x = np.interp(s, np.concatenate([[0], np.cumsum(seg)]), corners[:, 0])
    z = np.interp(s, np.concatenate([[0], np.cumsum(seg)]), corners[:, 1])
    P = np.stack([np.stack([x, np.zeros_like(x), z], 1),
                  np.stack([x, np.full_like(x, 0.08), z], 1)], 1)
    return _quads(P)[:n]


def build(n_tris: int, width: int, height: int,
          scene_seed: int = 0) -> TriScene:
    """The room with exactly n_tris triangles (at least ~1,200) and its
    camera at width × height."""
    parts = _parts(np.random.default_rng(scene_seed))
    lo_f, hi_f = 0.0, 2.0
    if _count(parts, lo_f) >= n_tris:
        raise ValueError(f"the room needs more than {n_tris} triangles")
    for _ in range(50):
        mid = 0.5 * (lo_f + hi_f)
        if _count(parts, mid) < n_tris:
            lo_f = mid
        else:
            hi_f = mid
    tris, mats = [], []
    for kind, args, full, mat in parts:
        t = _MAKE[kind](*args, *_res(kind, full, lo_f))
        tris.append(t)
        mats.append(np.full(len(t), MAT_ID[mat], np.int32))
    rest = n_tris - sum(len(t) for t in tris)
    tris.append(_skirting(rest))
    mats.append(np.full(rest, MAT_ID["wood"], np.int32))
    T = np.concatenate(tris).astype(np.float32)
    spec = list(MATERIALS.values())
    materials = dict(
        model=np.array([m[0] for m in spec], np.int32),
        diffuse=np.array([m[1] for m in spec], np.float32),
        fuzziness=np.array([m[2] for m in spec], np.float32),
        refraction_index=np.array([m[3] for m in spec], np.float32))
    f = float(np.float32(0.5 * height / np.tan(np.radians(FOV_DEG) * 0.5)))
    view = scene.View(scene.look_at(EYE, TARGET), f, f,
                      float(np.float32(width * 0.5)),
                      float(np.float32(height * 0.5)), width, height)
    return TriScene(v0=T[:, 0], v1=T[:, 1], v2=T[:, 2],
                    mat=np.concatenate(mats), materials=materials,
                    view=view)
