"""Plain PyTorch reference of the path-tracing cells.

It imports nothing of the program. From the benchmark's own inputs (the
triangles, their materials, the view and the random draws) it traces any
subset of a frame's pixels, and the answer for a pixel does not depend
on which others are traced with it.

The render it defines is RayTracingInVulkan's path tracer (its
`RayTracing.rgen`, `Scatter.glsl` and `Material.glsl`) over triangles:

- pinhole camera rays through the pixel (x, y) plus a jitter in [0, 1)²
  from the camera's position: d = c2w · normalise((x' − cx) / fx,
  (y' − cy) / fy, 1), with c2w the inverse of the world→camera view;
- the nearest hit with t_min < t < t_max over every triangle by
  Möller–Trumbore (ties to the lower triangle index); the geometric
  normal faces the ray, as the scene has no vertex normals;
- per ray, the direction is normalised before it scatters; Lambertian:
  normal + a random unit vector, scattered where the incoming direction
  meets the normal from the front; metal: the reflection plus fuzz times
  the random unit vector, scattered where it leaves the surface;
  dielectric: refraction with Schlick's reflectance chosen by a uniform
  draw, total internal reflection reflecting; a light adds its emission
  times the path's throughput and ends the path;
- no sky: a ray that hits nothing ends the path and adds nothing;
- `bounces` traced segments, the camera ray among them.

Departures from RayTracingInVulkan, all shared with the program: the
draws are a unit vector from a normalised Gaussian (RayTracingInVulkan
draws a point in the unit ball) and the inputs of `draws` below; a path
that is still scattering after its last segment adds nothing (there its
throughput is added as if it met light); a triangle has no inside, so a
dielectric triangle refracts as entering glass from either side.

Nearest hits run in blocks of triangles: a conservative bounding-sphere
test (two matrix products in float32, TF32 off, with a margin well
above their rounding) picks each ray's candidates, and Möller–Trumbore
decides among them elementwise. Every other step is elementwise. The
`dtype` argument computes the same in bfloat16 for the control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAMBERTIAN, METALLIC, DIELECTRIC, DIFFUSE_LIGHT = 0, 1, 2, 4
BLOCK_PAIRS = 1 << 27     # (ray, triangle) pairs a block of the sphere test
SPHERE_SLACK = 1e-5       # the sphere test's margin, relative to its terms


@dataclass
class Scene:
    """Triangles (v0, e1 = v1 − v0, e2 = v2 − v0, [N, 3]), their bounding
    spheres, material ids [N] and the material table, on one device."""
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    center: torch.Tensor      # [N, 3] float32
    radius: torch.Tensor      # [N] float32
    mat: torch.Tensor         # [N] int64
    model: torch.Tensor       # [M] int64
    albedo: torch.Tensor      # [M, 3]
    fuzz: torch.Tensor        # [M]
    ior: torch.Tensor         # [M]


def make_scene(v0, v1, v2, mat, materials: dict, device,
               dtype=torch.float32) -> Scene:
    """The reference's scene from NumPy triangles [N, 3] (float32),
    material ids [N] and the material table (model, diffuse, fuzziness,
    refraction_index)."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=device)
    a, b, c = f32(v0), f32(v1), f32(v2)
    lo = torch.minimum(torch.minimum(a, b), c).double()
    hi = torch.maximum(torch.maximum(a, b), c).double()
    center = 0.5 * (lo + hi)
    radius = 0.5 * (hi - lo).norm(dim=1)
    m = materials
    bad = set(np.unique(m["model"]).tolist()) - {LAMBERTIAN, METALLIC,
                                                 DIELECTRIC, DIFFUSE_LIGHT}
    if bad:
        raise ValueError(f"material models {sorted(bad)} are not traced")
    return Scene(v0=a.to(dtype), e1=(b - a).to(dtype), e2=(c - a).to(dtype),
                 center=center.float(), radius=radius.float() * (1 + 1e-6),
                 mat=torch.as_tensor(np.asarray(mat), device=device).long(),
                 model=torch.as_tensor(np.asarray(m["model"]),
                                       device=device).long(),
                 albedo=f32(m["diffuse"]).to(dtype),
                 fuzz=f32(m["fuzziness"]).to(dtype),
                 ior=f32(m["refraction_index"]).to(dtype))


def draws(seed: int, n_rays: int, bounces: int, device) -> dict:
    """The random draws of one frame, as inputs: one generator seeded
    with `seed` on `device`, and from it, in this order, the pixel jitter
    [R, 2], two [R] uniforms (a thin lens's disk, unused by a pinhole),
    then per segment a [R, 3] normal draw normalised per row and a [R]
    uniform. These are the calls and shapes the program makes for one
    sample, so both see the same numbers."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    rand = lambda *s: torch.rand(s, generator=g, device=device)  # noqa
    out = {"jitter": rand(n_rays, 2), "unit": [], "uniform": []}
    rand(n_rays)
    rand(n_rays)
    for _ in range(bounces):
        v = torch.randn((n_rays, 3), generator=g, device=device)
        out["unit"].append(v / torch.clamp_min(
            torch.linalg.norm(v, dim=-1, keepdim=True), 1e-9))
        out["uniform"].append(rand(n_rays))
    return out


def _dot(a, b):
    """Summed left to right per ray, so no ray depends on its batch."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalise(a):
    return a / torch.clamp_min(torch.sqrt(_dot(a, a)), 1e-12)[..., None]


def camera_rays(view, jitter, pixels, width: int, dtype=torch.float32):
    """Origins and directions [P, 3] of the camera rays of `pixels`
    (framebuffer indices) with their jitter rows. view is the [4, 4]
    world→camera matrix and (fx, fy, cx, cy) its intrinsics."""
    dev = jitter.device
    c2w = torch.linalg.inv(torch.as_tensor(view.view, device=dev))
    x = (pixels % width).float() + jitter[:, 0]
    y = torch.div(pixels, width, rounding_mode="floor").float() + jitter[:, 1]
    k = {a: torch.tensor(np.float32(getattr(view, a)), device=dev)
         for a in ("fx", "fy", "cx", "cy")}
    dx = (x - k["cx"]) / k["fx"]
    dy = (y - k["cy"]) / k["fy"]
    d_cam = _normalise(torch.stack([dx, dy, torch.ones_like(dx)], -1))
    R = c2w[:3, :3]
    d = (d_cam[:, 0:1] * R[:, 0] + d_cam[:, 1:2] * R[:, 1]
         + d_cam[:, 2:3] * R[:, 2])
    o = c2w[:3, 3].expand_as(d)
    return o.to(dtype), d.to(dtype)


def _candidates(sc: Scene, o, d, s: int, e: int):
    """(ray, triangle) pairs whose ray line passes within the triangle's
    bounding sphere, ahead of the origin, for triangles [s, e): a
    superset of the pairs that hit, whatever the rounding."""
    o, d = o.float(), d.float()
    c, r = sc.center[s:e], sc.radius[s:e]
    dd, od, oo = _dot(d, d), _dot(o, d), _dot(o, o)
    wd = d @ c.T - od[:, None]                               # (c − o)·d
    ww = _dot(c, c)[None] - 2.0 * (o @ c.T) + oo[:, None]    # |c − o|²
    scale = (c.abs().amax() + o.abs().amax()) ** 2 * 3.0
    near = ww * dd[:, None] - wd * wd <= \
        (r * r)[None] * dd[:, None] + SPHERE_SLACK * scale * dd[:, None]
    ahead = wd + r[None] * torch.sqrt(dd)[:, None] \
        + SPHERE_SLACK * scale >= 0.0
    return (near & ahead).nonzero(as_tuple=True)


def _moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """t of each pair (+inf where it misses)."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & \
        (t < t_max)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def nearest_hit(sc: Scene, o, d, t_min: float, t_max: float):
    """(t [P], triangle [P]) of the nearest hit of each ray (+inf, -1
    where none); ties go to the lower triangle index."""
    P, N = o.shape[0], sc.v0.shape[0]
    dev = o.device
    best_t = torch.full((P,), float("inf"), dtype=o.dtype, device=dev)
    best_i = torch.full((P,), -1, dtype=torch.int64, device=dev)
    step = max(1, BLOCK_PAIRS // max(P, 1))
    for s in range(0, N, step):
        ri, ti = _candidates(sc, o, d, s, min(N, s + step))
        if ri.numel() == 0:
            continue
        ti = ti + s
        t = _moller_trumbore(o[ri], d[ri], sc.v0[ti], sc.e1[ti], sc.e2[ti],
                             t_min, t_max)
        bt = torch.full_like(best_t, float("inf")).scatter_reduce(
            0, ri, t, "amin")
        won = torch.isfinite(t) & (t == bt[ri])
        bi = torch.full_like(best_i, N).scatter_reduce(
            0, ri[won], ti[won], "amin")
        take = (bt < best_t) | ((bt == best_t) & (bi < best_i)
                                & torch.isfinite(bt))
        best_t = torch.where(take, bt, best_t)
        best_i = torch.where(take, bi, best_i)
    return best_t, best_i


def _reflect(d, n):
    return d - 2.0 * _dot(d, n)[:, None] * n


def _refract(d, n, eta):
    """glsl refract(); 0 on total internal reflection."""
    cos_i = -_dot(d, n)[:, None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    r = eta * d + (eta * cos_i - torch.sqrt(torch.clamp_min(k, 0.0))) * n
    return torch.where(k >= 0, r, torch.zeros_like(r))


def _schlick(cosine, ior):
    r0 = (1 - ior) / (1 + ior)
    r0 = r0 * r0
    return r0 + (1 - r0) * (1 - cosine) ** 5


def scatter(model, albedo, fuzz, ior, d, n, unit, uni):
    """The scatter of each ray at its hit: model, albedo [P, 3], fuzz
    and refractive index of its material, d its direction (any length),
    n the unit normal facing it, unit and uni its draws. Returns the
    attenuation [P, 3], the new direction [P, 3], whether the path goes
    on [P] and whether it met a light [P]."""
    dn = _normalise(d)
    cos_dn = _dot(dn, n)
    refl = _reflect(dn, n)
    inside = cos_dn > 0
    outward = torch.where(inside[:, None], -n, n)
    eta = torch.where(inside, ior, 1.0 / ior)
    cosine = torch.where(inside, ior * cos_dn, -cos_dn)
    refr = _refract(dn, outward, eta[:, None])
    p_refl = torch.where(_dot(refr, refr) == 0, torch.ones_like(cosine),
                         _schlick(cosine, ior))
    is_lam, is_met = model == LAMBERTIAN, model == METALLIC
    is_die, is_light = model == DIELECTRIC, model == DIFFUSE_LIGHT
    new_d = torch.where(
        is_lam[:, None], n + unit, torch.where(
            is_met[:, None], refl + fuzz[:, None] * unit,
            torch.where((uni < p_refl)[:, None], refl, refr)))
    go = torch.where(is_lam, cos_dn < 0,
                     torch.where(is_met, _dot(refl, n) > 0, is_die))
    atten = torch.where(is_die[:, None], torch.ones_like(albedo), albedo)
    return atten, new_d, go, is_light


def trace(sc: Scene, view, seed: int, pixels, *, bounces: int,
          t_min: float, t_max: float, dtype=torch.float32):
    """Linear colour [P, 3] (float32) and the bounce-0 triangle [P] (-1
    on a miss) of `pixels` ([P] framebuffer indices) of the frame drawn
    from `seed`."""
    dev = sc.v0.device
    W, H = view.width, view.height
    pixels = torch.as_tensor(pixels, device=dev).long()
    dr = draws(seed, W * H, bounces, dev)
    jit = dr["jitter"][pixels]
    units = [u[pixels].to(dtype) for u in dr["unit"]]
    unis = [u[pixels].to(dtype) for u in dr["uniform"]]
    del dr
    o, d = camera_rays(view, jit, pixels, W, dtype)
    P = pixels.shape[0]
    color = torch.zeros((P, 3), dtype=dtype, device=dev)
    through = torch.ones((P, 3), dtype=dtype, device=dev)
    primary = torch.full((P,), -1, dtype=torch.int64, device=dev)
    live = torch.arange(P, device=dev)          # the paths still going
    for b in range(bounces):
        if live.numel() == 0:
            break
        t, tri = nearest_hit(sc, o, d, t_min, t_max)
        if b == 0:
            primary = tri
        hit = tri >= 0
        live, o, d, t, tri = live[hit], o[hit], d[hit], t[hit], tri[hit]
        n = _normalise(_cross(sc.e1[tri], sc.e2[tri]))
        n = torch.where((_dot(n, d) > 0)[:, None], -n, n)
        m = sc.mat[tri]
        albedo = sc.albedo[m]
        atten, new_d, go, light = scatter(
            sc.model[m], albedo, sc.fuzz[m], sc.ior[m], d, n,
            units[b][live], unis[b][live])
        color[live] += torch.where(light[:, None], through[live] * albedo,
                                   0.0)
        through[live] = through[live] * atten
        live, o, d = live[go], (o + t[:, None] * d)[go], new_d[go]
    return color.float(), primary
