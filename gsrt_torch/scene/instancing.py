"""Instancing: shared geometry replicated under per-instance transforms
(counterpart of `gsrt.scene.instancing`).

Resolved when the scene is built, in host NumPy as in the JAX package:
every primitive is copied once per transform with the transform applied,
so traversal sees one flat scene. Boxes stay boxes under axis-aligned
transforms and become 12 triangles otherwise; cylinders accept only
transforms that keep the y axis; Mandelbulbs move and scale their bound.
The result goes to the input's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gsrt_torch.core.types import GaussianCloud
from gsrt_torch.models.path_tracer import PrimitiveScene


def make_transform(translate=(0, 0, 0), rotate_y_deg: float = 0.0,
                   scale: float = 1.0) -> np.ndarray:
    """[3, 4] affine: scale, then rotate about y, then translate."""
    a = np.radians(rotate_y_deg)
    c, s = np.cos(a), np.sin(a)
    T = np.zeros((3, 4), np.float32)
    T[:, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                        np.float32) * scale
    T[:, 3] = translate
    return T


def _apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ T[:, :3].T + T[:, 3]


def _is_axis_aligned(R: np.ndarray, tol: float = 1e-6) -> bool:
    """Does the linear part map axes onto axes (one nonzero a row and a
    column)?"""
    nz = np.abs(R) > tol * max(np.abs(R).max(), 1e-12)
    return bool((nz.sum(0) == 1).all() and (nz.sum(1) == 1).all())


# a box's 12 triangles from its 8 corners (corner bit 1: x hi, 2: y hi,
# 4: z hi), wound outward
_BOX_TRI_IDX = np.array([
    [0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6], [0, 1, 4], [1, 5, 4],
    [2, 6, 3], [3, 6, 7], [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5],
], np.int32)


def _np(a):
    return None if a is None else a.detach().cpu().numpy()


def instantiate_scene(scene: PrimitiveScene,
                      transforms: Sequence[np.ndarray]) -> PrimitiveScene:
    """Every primitive of `scene` once per [3, 4] transform; materials,
    textures and cutout masks are shared."""
    dev = scene.device
    f = {k: _np(v) for k, v in scene._asdict().items()
         if isinstance(v, torch.Tensor)}
    has_uv = f.get("tri_uv0") is not None
    has_cyl = f.get("cyl_center") is not None and f["cyl_center"].shape[0]
    has_mnd = f.get("mnd_center") is not None and f["mnd_center"].shape[0]
    parts = {k: [] for k in ("sph_center", "sph_radius", "sph_mat",
                             "box_min", "box_max", "box_mat", "tri_v0",
                             "tri_v1", "tri_v2", "tri_mat", "tri_uv0",
                             "tri_uv1", "tri_uv2", "cyl_center",
                             "cyl_radius", "cyl_half_h", "cyl_mat",
                             "mnd_center", "mnd_radius", "mnd_mat")}

    def add(**kw):
        for k, v in kw.items():
            parts[k].append(v)

    for T in transforms:
        T = np.asarray(T, np.float32)
        # |det|^(1/3): reflections keep sizes; a non-uniform scale takes
        # its geometric mean (spheres stay spheres)
        uniform_scale = float(np.cbrt(abs(np.linalg.det(T[:, :3]))))
        if f["sph_center"].shape[0]:
            add(sph_center=_apply(T, f["sph_center"]),
                sph_radius=f["sph_radius"] * uniform_scale,
                sph_mat=f["sph_mat"])
        if f["box_min"].shape[0]:
            lo, hi = f["box_min"], f["box_max"]
            corners = np.stack([
                np.stack([np.where(m & 1, hi[:, 0], lo[:, 0]),
                          np.where(m & 2, hi[:, 1], lo[:, 1]),
                          np.where(m & 4, hi[:, 2], lo[:, 2])], -1)
                for m in range(8)], 1)                      # [B, 8, 3]
            tc = _apply(T, corners.reshape(-1, 3)).reshape(-1, 8, 3)
            if _is_axis_aligned(T[:, :3]):
                add(box_min=tc.min(1), box_max=tc.max(1),
                    box_mat=f["box_mat"])
            else:
                # a rotated box is no AABB: 12 triangles a box
                v = [tc[:, _BOX_TRI_IDX[:, k], :].reshape(-1, 3)
                     for k in range(3)]
                add(tri_v0=v[0], tri_v1=v[1], tri_v2=v[2],
                    tri_mat=np.repeat(f["box_mat"], 12))
                if has_uv:
                    z = np.zeros((v[0].shape[0], 2), np.float32)
                    add(tri_uv0=z, tri_uv1=z, tri_uv2=z)
        if has_cyl:
            col_y = T[:, :3] @ np.array([0.0, 1.0, 0.0], np.float32)
            if abs(col_y[0]) >= 1e-5 or abs(col_y[2]) >= 1e-5:
                raise ValueError("cylinder instancing needs a transform "
                                 "that keeps the y axis")
            add(cyl_center=_apply(T, f["cyl_center"]),
                cyl_radius=f["cyl_radius"] * uniform_scale,
                cyl_half_h=f["cyl_half_h"] * abs(float(col_y[1])),
                cyl_mat=f["cyl_mat"])
        if has_mnd:
            add(mnd_center=_apply(T, f["mnd_center"]),
                mnd_radius=f["mnd_radius"] * uniform_scale,
                mnd_mat=f["mnd_mat"])
        if f["tri_v0"].shape[0]:
            add(tri_v0=_apply(T, f["tri_v0"]), tri_v1=_apply(T, f["tri_v1"]),
                tri_v2=_apply(T, f["tri_v2"]), tri_mat=f["tri_mat"])
            if has_uv:
                add(tri_uv0=f["tri_uv0"], tri_uv1=f["tri_uv1"],
                    tri_uv2=f["tri_uv2"])

    def cat(k, width=None, dtype=np.float32):
        a = np.concatenate(parts[k], 0) if parts[k] else \
            np.zeros((0,) if width is None else (0, width))
        return torch.as_tensor(a.astype(dtype), device=dev)

    i32 = np.int32
    return PrimitiveScene(
        sph_center=cat("sph_center", 3), sph_radius=cat("sph_radius"),
        sph_mat=cat("sph_mat", dtype=i32),
        box_min=cat("box_min", 3), box_max=cat("box_max", 3),
        box_mat=cat("box_mat", dtype=i32),
        tri_v0=cat("tri_v0", 3), tri_v1=cat("tri_v1", 3),
        tri_v2=cat("tri_v2", 3), tri_mat=cat("tri_mat", dtype=i32),
        materials=scene.materials, textures=scene.textures,
        alpha_textures=scene.alpha_textures,
        tri_uv0=cat("tri_uv0", 2) if has_uv else None,
        tri_uv1=cat("tri_uv1", 2) if has_uv else None,
        tri_uv2=cat("tri_uv2", 2) if has_uv else None,
        cyl_center=cat("cyl_center", 3) if has_cyl else None,
        cyl_radius=cat("cyl_radius") if has_cyl else None,
        cyl_half_h=cat("cyl_half_h") if has_cyl else None,
        cyl_mat=cat("cyl_mat", dtype=i32) if has_cyl else None,
        mnd_center=cat("mnd_center", 3) if has_mnd else None,
        mnd_radius=cat("mnd_radius") if has_mnd else None,
        mnd_mat=cat("mnd_mat", dtype=i32) if has_mnd else None)


def instantiate_cloud(cloud: GaussianCloud,
                      transforms: Sequence[np.ndarray]) -> GaussianCloud:
    """A cloud once per transform: means moved, Σ ← A Σ Aᵀ for the linear
    part A."""
    c = _np(cloud.cov3d)
    sig0 = np.zeros((c.shape[0], 3, 3), np.float32)
    sig0[:, 0, 0], sig0[:, 0, 1], sig0[:, 0, 2] = c[:, 0], c[:, 1], c[:, 2]
    sig0[:, 1, 0], sig0[:, 1, 1], sig0[:, 1, 2] = c[:, 1], c[:, 3], c[:, 4]
    sig0[:, 2, 0], sig0[:, 2, 1], sig0[:, 2, 2] = c[:, 2], c[:, 4], c[:, 5]
    means, covs, ops, shs = [], [], [], []
    for T in transforms:
        T = np.asarray(T, np.float32)
        A = T[:, :3]
        sig = np.einsum("ij,njk,lk->nil", A, sig0, A)
        covs.append(np.stack([sig[:, 0, 0], sig[:, 0, 1], sig[:, 0, 2],
                              sig[:, 1, 1], sig[:, 1, 2], sig[:, 2, 2]], -1))
        means.append(_apply(T, _np(cloud.means)))
        ops.append(_np(cloud.opacity))
        shs.append(_np(cloud.sh))
    dev = cloud.device
    return GaussianCloud(*(torch.as_tensor(np.concatenate(a), device=dev)
                           for a in (means, covs, ops, shs)))
