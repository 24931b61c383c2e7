"""The meshes of the hybrid path-tracing cells, inserted into the splat
cloud as 3DGRT inserts meshes into a captured particle scene: a mirror
and a glass ball, each an icosphere, and a ground quad under the cloud.
The materials are the port's `mirror_in_gaussians` scene's (a fuzz-0
metal sphere, a Lambertian ground) and a dielectric ball of refractive
index 1.5 beside the mirror.

An icosphere is the icosahedron's 20 faces, each split into four
`subdivision` times, its new corners pushed out onto the sphere: 20·4^s
triangles, 81,920 at s = 6, whose edges (~0.03 at radius 1.5) are a few
splat widths. A shared edge's midpoint is computed from the same two
corners on both sides, so the mesh has no cracks. The splat cloud is
`scene.random_cloud`'s, as the ray-traced splat cells make it.
"""

from __future__ import annotations

import numpy as np

from benchmark import tri_scene

LAMBERTIAN, METALLIC, DIELECTRIC = (tri_scene.LAMBERTIAN,
                                    tri_scene.METALLIC,
                                    tri_scene.DIELECTRIC)
PHI = (1.0 + 5.0 ** 0.5) / 2.0


def icosphere(subdivision: int) -> np.ndarray:
    """The unit icosphere's triangles, [20·4^s, 3, 3] float64."""
    v = np.array([(-1, PHI, 0), (1, PHI, 0), (-1, -PHI, 0), (1, -PHI, 0),
                  (0, -1, PHI), (0, 1, PHI), (0, -1, -PHI), (0, 1, -PHI),
                  (PHI, 0, -1), (PHI, 0, 1), (-PHI, 0, -1), (-PHI, 0, 1)],
                 np.float64)
    f = np.array([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
                  (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
                  (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
                  (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)])
    t = v[f] / np.linalg.norm(v[f], axis=-1, keepdims=True)
    for _ in range(subdivision):
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        ab, bc, ca = ((p + q) * 0.5 for p, q in ((a, b), (b, c), (c, a)))
        ab, bc, ca = (m / np.linalg.norm(m, axis=-1, keepdims=True)
                      for m in (ab, bc, ca))
        t = np.concatenate([np.stack(x, 1) for x in
                            ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                             (ab, bc, ca))])
    return t


def build(meshes: dict) -> tri_scene.TriScene:
    """The configuration's `meshes` group as triangles (float32) with
    their material ids and table: the ground (material 0), the mirror
    (1), the glass (2). The views are the traffic mix's, so `view` is
    None."""
    ball = icosphere(int(meshes["subdivision"]))
    g = meshes["ground"]
    (x0, x1), (z0, z1), y = g["x"], g["z"], g["y"]
    quad = np.array([[(x0, y, z0), (x1, y, z0), (x1, y, z1)],
                     [(x0, y, z0), (x1, y, z1), (x0, y, z1)]], np.float64)
    parts, mats = [quad], [np.zeros(2, np.int32)]
    for m, key in ((1, "mirror"), (2, "glass")):
        s = meshes[key]
        parts.append(np.asarray(s["center"]) + s["radius"] * ball)
        mats.append(np.full(len(ball), m, np.int32))
    T = np.concatenate(parts).astype(np.float32)
    mi, gl = meshes["mirror"], meshes["glass"]
    materials = dict(
        model=np.array([LAMBERTIAN, METALLIC, DIELECTRIC], np.int32),
        diffuse=np.array([g["albedo"], mi["albedo"], (1.0, 1.0, 1.0)],
                         np.float32),
        fuzziness=np.array([0.0, mi["fuzz"], 0.0], np.float32),
        refraction_index=np.array([1.0, 1.0, gl["ior"]], np.float32))
    return tri_scene.TriScene(v0=T[:, 0], v1=T[:, 1], v2=T[:, 2],
                              mat=np.concatenate(mats),
                              materials=materials, view=None)
