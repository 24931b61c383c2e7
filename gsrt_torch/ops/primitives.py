"""Analytic ray-primitive intersections, batched (counterpart of
`gsrt.ops.primitives`).

Rays [R, 3] broadcast against primitives [P, ...] to hit distances [R, P]
(+inf on a miss), in the JAX package's operation order: the sphere
quadratic with a = |d|², the slab test, capped y-axis cylinders,
brute-force Möller–Trumbore, and the sphere-bounded distance-estimator
march of power-8 Mandelbulbs (its two `fori_loop`s are Python loops).
"""

from __future__ import annotations

import math

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


def _sqrt(x):
    """Correctly rounded f32 square root, as XLA and CUDA take it. torch's
    CPU kernel (SLEEF's 0.5-ulp root) may round the other way next to a
    midpoint, which the ground sphere's cancelling quadratic turns into a
    1% change of t; the f64 root rounded to f32 is the correct one."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def _norm(a, keepdim=False):
    n = _sqrt(_dot(a, a))
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
    sq = _sqrt(torch.clamp_min(disc, 0.0))
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


def ray_cylinder(orig, dirn, centers, radii, half_h, t_min, t_max):
    """[R, 3] rays vs [P] capped y-axis cylinders → t [R, P] (+inf on a
    miss): the nearer of the side surface within ±half_h and the caps."""
    oc = orig[:, None, :] - centers[None, :, :]
    dx, dz = dirn[:, None, 0], dirn[:, None, 2]
    ox, oz = oc[..., 0], oc[..., 2]
    r2 = (radii ** 2)[None, :]
    a = dx * dx + dz * dz
    b = ox * dx + oz * dz
    c = ox * ox + oz * oz - r2
    disc = b * b - a * c
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a.abs() > 1e-12, a, torch.full_like(a, 1e-12))
    t0 = (-b - sq) / a_safe
    t1 = (-b + sq) / a_safe
    hh = half_h[None, :]
    inf = torch.full_like(t0, INF)

    def side_ok(t):
        y = oc[..., 1] + t * dirn[:, None, 1]
        return (disc > 0) & (t > t_min) & (t < t_max) & (y.abs() <= hh)

    t_side = torch.where(side_ok(t0), t0,
                         torch.where(side_ok(t1), t1, inf))
    dy = dirn[:, None, 1]
    dy_ok = dy.abs() > 1e-12
    dy_safe = torch.where(dy_ok, dy, torch.full_like(dy, 1e-12))
    t_cap = inf
    for s in (-1.0, 1.0):
        tc = (s * hh - oc[..., 1]) / dy_safe
        x = ox + tc * dx
        z = oz + tc * dz
        ok = (tc > t_min) & (tc < t_max) & (x * x + z * z <= r2) & dy_ok
        t_cap = torch.minimum(t_cap, torch.where(ok, tc, inf))
    return torch.minimum(t_side, t_cap)


def cylinder_normal(point, center, radius, half_h, eps: float = 1e-4):
    """Outward normal of a capped y-axis cylinder at a surface point: the
    cap's (0, ±1, 0) within eps·half_h of a cap plane, else radial."""
    rel = point - center
    on_cap = (rel[..., 1].abs() - half_h).abs() <= eps * half_h
    zero = torch.zeros_like(rel[..., 1])
    cap_n = torch.stack([zero, torch.sign(rel[..., 1]), zero], -1)
    side = torch.stack([rel[..., 0], zero, rel[..., 2]], -1)
    side_n = side / torch.clamp_min(_norm(side, keepdim=True), 1e-12)
    return torch.where(on_cap[..., None], cap_n, side_n)


def mandelbulb_de(p, power: float = 8.0, iters: int = 8):
    """Power-8 Mandelbulb distance estimator, [..., 3] → [...], with the
    45° pre-rotation about z. Lanes that escaped (radius > 2) keep their
    state, as the JAX package's `where`s keep it."""
    # cos and sin of pi/4 rounded to f32, as the JAX package takes them
    c = s = float(torch.tensor(math.cos(math.pi / 4), dtype=torch.float32))
    px = p[..., 0] * c - p[..., 1] * s
    py = p[..., 0] * s + p[..., 1] * c
    p = torch.stack([px, py, p[..., 2]], -1)
    zn = p
    m = _dot(zn, zn)
    dz = torch.ones_like(m)
    h = torch.zeros_like(m)
    for _ in range(iters):
        m_safe = torch.clamp_min(m, 1e-20)
        rad = _sqrt(m_safe)
        escaped = rad > 2.0
        h_new = 0.25 * torch.log(m_safe) * rad / dz
        dz_new = power * m ** 3.5 * dz + 1.0
        rxy = _sqrt(zn[..., 0] * zn[..., 0] + zn[..., 1] * zn[..., 1])
        th = torch.atan2(rxy, zn[..., 2])
        phi = torch.atan2(zn[..., 1], zn[..., 0])
        rp = rad ** power
        sin_th = torch.sin(power * th)
        zn_new = torch.stack(
            [rp * sin_th * torch.cos(power * phi),
             rp * sin_th * torch.sin(power * phi),
             rp * torch.cos(power * th)], -1) + p
        zn = torch.where(escaped[..., None], zn, zn_new)
        dz = torch.where(escaped, dz, dz_new)
        h = torch.where(escaped, h_new, h)
        m = _dot(zn, zn)
    return h


def ray_mandelbulb(orig, dirn, centers, radii, t_min, t_max,
                   steps: int = 96):
    """Sphere-bounded distance-estimator march, [R, 3] rays × [P] bulbs →
    t [R, P] (+inf on a miss). The march runs on the normalised ray from
    the bounding sphere's entry (or t_min for origins inside it), steps
    by the estimate while t ≤ the sphere's exit, and converts back to the
    caller's parameter. Only (ray, bulb) pairs that meet the bounding
    sphere march; the others keep t = exit + 1, as they would."""
    dmag = torch.clamp_min(_norm(dirn, keepdim=True), 1e-12)        # [R,1]
    dn = dirn / dmag
    oc = orig[:, None, :] - centers[None, :, :]
    b = _dot(oc, dn[:, None, :])                                     # [R,P]
    c = _dot(oc, oc) - (radii ** 2)[None, :]
    disc = b * b - c
    sq = _sqrt(torch.clamp_min(disc, 0.0))
    t_entry = -b - sq
    t_exit = -b + sq
    tmin_w = torch.as_tensor(t_min, dtype=dmag.dtype,
                             device=dmag.device) * dmag
    tmax_w = torch.as_tensor(t_max, dtype=dmag.dtype,
                             device=dmag.device) * dmag
    inside = c < 0
    start = torch.maximum(torch.where(inside, tmin_w, t_entry), tmin_w)
    valid = (disc > 0) & (t_exit > tmin_w) & (start < tmax_w)
    t = torch.where(valid, start, t_exit + 1.0)
    ri, pi = valid.nonzero(as_tuple=True)
    if ri.numel():
        o_v, d_v, c_v = orig[ri], dn[ri], centers[pi]
        exit_v = t_exit[ri, pi]
        tv = t[ri, pi]
        for _ in range(steps):
            pt = o_v + tv[:, None] * d_v
            d = mandelbulb_de(pt - c_v)
            tv = torch.where(tv <= exit_v, tv + d, tv)
        t = t.index_put((ri, pi), tv)
    hit = (t <= t_exit) & valid & (t < tmax_w)
    return torch.where(hit, t / dmag, torch.full_like(t, INF))


def mandelbulb_normal(p, eps: float = 1e-3):
    """Central-difference gradient of the distance estimate, normalised."""
    n = []
    for ax in range(3):
        e = torch.zeros(3, dtype=p.dtype, device=p.device)
        e[ax] = eps
        n.append(mandelbulb_de(p + e) - mandelbulb_de(p - e))
    return _normalize(torch.stack(n, -1))
