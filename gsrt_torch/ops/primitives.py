"""Analytic ray-primitive intersections, batched (counterpart of
`gsrt.ops.primitives`).

Rays [R, 3] broadcast against primitives [P, ...] to hit distances [R, P]
(+inf on a miss), in the JAX package's operation order: the sphere
quadratic with a = |d|², the slab test, and brute-force Möller–Trumbore.
The cylinder and Mandelbulb tests are not ported yet (ROADMAP.md Queue 1
item 12).
"""

from __future__ import annotations

import torch

INF = float("inf")


def _dot(a, b):
    """a · b over the last axis of 3, summed left to right as elementwise
    ops: `(a * b).sum(-1)` on CUDA may sum a row in another order
    depending on its address, so a ray's hit would change with its place
    in the batch (the coherence sort moves rays)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _norm(a, keepdim=False):
    n = torch.sqrt(_dot(a, a))
    return n[..., None] if keepdim else n


def _normalize(a):
    return a / torch.clamp_min(_norm(a, keepdim=True), 1e-12)


def ray_sphere(orig, dirn, centers, radii, t_min, t_max):
    """[R, 3] rays vs [P] spheres → t [R, P] (+inf on a miss): the nearest
    root of |o + t·d − c|² = r² inside (t_min, t_max)."""
    oc = orig[:, None, :] - centers[None, :, :]
    a = _dot(dirn, dirn)[:, None]
    b = _dot(oc, dirn[:, None, :])
    c = _dot(oc, oc) - (radii ** 2)[None, :]
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.clamp_min(a, 1e-12)
    t0 = (-b - sq) / a_safe
    t1 = (-b + sq) / a_safe
    inf = torch.full_like(t0, INF)
    t = torch.where((t0 > t_min) & (t0 < t_max), t0,
                    torch.where((t1 > t_min) & (t1 < t_max), t1, inf))
    return torch.where(disc > 0, t, inf)


def sphere_normal(point, center):
    return _normalize(point - center)


def ray_box(orig, dirn, box_min, box_max, t_min, t_max):
    """[R, 3] rays vs [P] AABBs (slab test) → t [R, P]."""
    small = torch.where(dirn >= 0, torch.full_like(dirn, 1e-12),
                        torch.full_like(dirn, -1e-12))
    inv = 1.0 / torch.where(dirn.abs() > 1e-12, dirn, small)
    lo = (box_min[None, :, :] - orig[:, None, :]) * inv[:, None, :]
    hi = (box_max[None, :, :] - orig[:, None, :]) * inv[:, None, :]
    t_near = torch.minimum(lo, hi).amax(-1)
    t_far = torch.maximum(lo, hi).amin(-1)
    hit = (t_near <= t_far) & (t_far > t_min)
    t = torch.where(t_near > t_min, t_near, t_far)
    return torch.where(hit & (t > t_min) & (t < t_max), t,
                       torch.full_like(t, INF))


def box_normal(point, box_min, box_max):
    """Outward normal of the face containing `point`."""
    center = 0.5 * (box_min + box_max)
    half = 0.5 * (box_max - box_min)
    local = (point - center) / torch.clamp_min(half, 1e-12)
    ax = local.abs().argmax(-1)
    sign = torch.sign(torch.gather(local, -1, ax[..., None]))
    return torch.eye(3, dtype=point.dtype, device=point.device)[ax] * sign


def ray_triangle(orig, dirn, v0, v1, v2, t_min, t_max):
    """Möller–Trumbore, [R, 3] rays × [P] triangles → (t [R, P], u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(dirn[:, None, :], e2[None, :, :])
    det = _dot(e1[None, :, :], pvec)
    ok_det = det.abs() > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros_like(det))
    tvec = orig[:, None, :] - v0[None, :, :]
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1[None, :, :])
    v = _dot(dirn[:, None, :], qvec) * inv_det
    t = _dot(e2[None, :, :], qvec) * inv_det
    hit = (ok_det & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
           & (t < t_max))
    return torch.where(hit, t, torch.full_like(t, INF)), u, v


def triangle_normal(v0, v1, v2):
    return _normalize(_cross(v1 - v0, v2 - v0))
