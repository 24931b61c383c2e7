"""Plain PyTorch reference of the hybrid path-tracing cells: splats and
triangles in one scene, the splats seen along every segment of a path,
primary, reflected and refracted alike (3DGRT, Moenne-Loccoz et al.,
SIGGRAPH Asia 2024, arXiv 2407.07090: meshes inserted into a particle
scene; the reference repo's Gauss primitive inside RayTracingInVulkan's
path tracer).

It imports nothing of the program. From the benchmark's own inputs (the
triangles and their materials, the splat parameters, the view, the
configuration's constants and the random draws) it traces any subset of
a frame's pixels, and the answer for a pixel does not depend on which
others are traced with it. It extends `pathtrace.py` (triangles, draws,
scatter) and `splat_rt.py` (the ray-space response, the k-buffer passes)
to rays of their own origins and windows:

- a path's segments are `pathtrace.py`'s: the camera ray, then each
  scattered ray from its hit point, `bounces` segments in all;
- each segment, from its origin to its nearest triangle hit (t_max where
  it hits none), composites the splats whose t* lies in (t_min, t_hit)
  by the k = 8 passes of `splat_rt.py`: their in-scatter times the
  path's throughput is added to the pixel, and their transmittance
  scales the throughput;
- a segment that hits no triangle adds the sky times the throughput and
  ends the path; the sky is the program's (RayTracingInVulkan's miss
  shader): t = ½·(d_y / |d| + 1), (1 − t)·(1, 1, 1) + t·(0.5, 0.7, 1.0),
  |d| summed as x² + z², then y²;
- then the triangle's material scatters, as in `pathtrace.py`.

Departures from 3DGRT and RayTracingInVulkan, all shared with the
program: each splat's colour is its degree-3 SH seen from the eye, once
a frame, not in the direction of the ray that meets it (3DGRT evaluates
SH per ray); `pathtrace.py`'s (the draws, a path still scattering after
its last segment adds nothing, a triangle has no inside); the response
is the ray-space one of `splat_rt.py` (t* the point of largest response,
g half its Mahalanobis distance), not the reference repo's screen-space
conic, since only it serves rays that start inside the cloud.

How it runs, to fit 2.96M splats: segments in blocks of rays, splats in
chunks of neighbours (by Morton code); a conservative bounding sphere of
each splat (`splat_rt.py`'s radius), and one round each chunk's, drop
the pairs whose line passes farther from the centre or whose chord lies
outside the window, compared in float64 with a margin far above its
rounding; the pairs left are evaluated exactly, each ray's accepted hits
sorted by (t*, the splat's rank in the cloud) and the passes run over
them.

`dtype` is the arithmetic of the rays, triangles, scatter, response and
composite (float32 is the reference; the control computes them in
bfloat16, with the same float64 cull); `window=False` composites each
segment's splats past its surface hit as well (a fault the control
reads).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import pathtrace, splat_rt
from benchmark.reference.splats import sh_color

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK_RAYS = 4096          # rays a block of a segment
CHUNK_SPLATS = 1 << 15     # splats a chunk of the cull, nearby in space
CULL_SLACK = 1e-9          # of the cull's terms, added to its tests
SKY_TOP = (0.5, 0.7, 1.0)


@dataclass
class Splats:
    """The splats above the alpha threshold, as a frame traces them, in
    the order of their Morton codes (so a chunk of them is compact), with
    `index` their rank in the cloud (ties go to the lower)."""
    means: torch.Tensor       # [N, 3] dtype
    cov_inv: torch.Tensor     # [N, 6] dtype
    op: torch.Tensor          # [N] dtype
    colors: torch.Tensor      # [N, 3] dtype, SH seen from the eye
    index: torch.Tensor       # [N] int64
    mu: torch.Tensor          # [N, 3] float64
    r2: torch.Tensor          # [N] float64, the bounding sphere's r²
    chunk_mu: torch.Tensor    # [C, 3] float64, a sphere round each chunk's
    chunk_r2: torch.Tensor    # [C] float64     bounding spheres


def _morton(x):
    """30-bit Morton codes of points [N, 3] in their bounding box."""
    lo, hi = x.amin(0), x.amax(0)
    q = ((x - lo) / torch.clamp_min(hi - lo, 1e-30) * 1023).long()
    q = q.clamp(0, 1023)
    for shift, mask in ((16, 0x30000FF), (8, 0x300F00F), (4, 0x30C30C3),
                        (2, 0x9249249)):
        q = (q | (q << shift)) & mask
    return (q[:, 0] << 2) | (q[:, 1] << 1) | q[:, 2]


def splats(cloud, cov6, view, consts: dict, dtype=torch.float32) -> Splats:
    """The splats of a scene.Cloud (cov6 its [N, 6] Σ) that a frame from
    `view` traces: those above the alpha threshold, their SH seen from
    the view's eye, and their bounding spheres."""
    dev = cloud.means.device
    keep = (cloud.opacity > consts["alpha_threshold"]).nonzero()[:, 0]
    keep = keep[torch.argsort(_morton(cloud.means[keep].double()),
                              stable=True)]
    cov = cov6[keep].float()
    op = cloud.opacity[keep].float()
    g_max = torch.clamp(torch.log(op / consts["alpha_threshold"]), 0.0,
                        consts["g_cutoff"])
    r2 = (2.0 * g_max * (cov[:, 0] + cov[:, 3] + cov[:, 5])) * 1.0201
    eye, _ = splat_rt.rays(view, torch.zeros(1, dtype=torch.long,
                                             device=dev), dev)
    m = cloud.means[keep].float()
    to_eye = m - eye
    to_eye = to_eye / torch.clamp_min(
        torch.sqrt((to_eye * to_eye).sum(-1, keepdim=True)), 1e-9)
    m64, r64 = m.double(), r2.double()
    c_mu, c_r2 = [], []
    for c0 in range(0, keep.numel(), CHUNK_SPLATS):
        mu, r = m64[c0:c0 + CHUNK_SPLATS], r64[c0:c0 + CHUNK_SPLATS].sqrt()
        c = 0.5 * ((mu - r[:, None]).amin(0) + (mu + r[:, None]).amax(0))
        c_mu.append(c)
        c_r2.append((((mu - c) ** 2).sum(-1).sqrt() + r).amax() ** 2
                    * (1 + 1e-6))
    return Splats(means=m.to(dtype), cov_inv=splat_rt.inverse_cov(
        cov6[keep].to(dtype)), op=op.to(dtype),
        colors=sh_color(cloud.sh[keep].to(dtype), to_eye.to(dtype)),
        index=keep, mu=m64, r2=r64,
        chunk_mu=torch.stack(c_mu) if c_mu else m64[:0],
        chunk_r2=torch.stack(c_r2) if c_r2 else r64[:0])


def _near(o, d, dd, mu, r2, lo_t, hi_t):
    """[B, S] whether each ray's line (o, d [B, 3], dd = |d|² [B, 1])
    passes within r of each sphere (mu [S, 3], r2 [S]), with the chord
    of the sphere, (m·d ± r·|d|)/|d|², m = mu − o, meeting the window
    (lo_t/|d|², hi_t/|d|²) [B, 1]; all float64, a superset whatever the
    rounding."""
    ones = torch.ones_like(o[:, :1])
    # |m|² = [−2o, 1, |o|²]·[mu, |mu|², 1]; m·d = [d, −o·d]·[mu, 1]
    mm = torch.cat([-2.0 * o, ones, (o * o).sum(-1, keepdim=True)], 1) \
        @ torch.cat([mu.T, (mu * mu).sum(-1)[None],
                     torch.ones_like(mu[:, :1]).T])
    md = torch.cat([d, -(o * d).sum(-1, keepdim=True)], 1) \
        @ torch.cat([mu.T, torch.ones_like(mu[:, :1]).T])
    slack = CULL_SLACK * (mm.abs() * dd + md * md)
    ok = mm * dd - md * md <= r2[None] * dd + slack
    rd = torch.sqrt(r2[None] * dd) + CULL_SLACK * (md.abs() + 1.0)
    return ok & (md + rd >= lo_t) & (md - rd <= hi_t)


def _hits(sp: Splats, o, d, hi, consts: dict, dtype):
    """Every accepted hit of the rays (o, d) [B, 3] with t* in
    (t_min, hi [B]): (ray, t*, splat, alpha), sorted by ray, t*, and the
    splat's rank in the cloud; a chunk of splats is tested only against
    the rays that pass its sphere."""
    o64, d64 = o.double(), d.double()
    dd = (d64 * d64).sum(-1, keepdim=True)
    lo_t, hi_t = consts["t_min"] * dd, hi.double()[:, None] * dd
    rays = _near(o64, d64, dd, sp.chunk_mu, sp.chunk_r2, lo_t, hi_t)
    found = []
    for c, c0 in enumerate(range(0, sp.mu.shape[0], CHUNK_SPLATS)):
        sel = rays[:, c].nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        sl = slice(c0, c0 + CHUNK_SPLATS)
        ray, j = _near(o64[sel], d64[sel], dd[sel], sp.mu[sl], sp.r2[sl],
                       lo_t[sel], hi_t[sel]).nonzero().unbind(1)
        ray, j = sel[ray], j + c0
        t_star, g = splat_rt.response(o[ray].to(dtype), d[ray].to(dtype),
                                      sp.means[j], sp.cov_inv[j])
        alpha = torch.clamp_max(sp.op[j] * torch.exp(-g),
                                splat_rt.ALPHA_CLAMP)
        acc = ((g <= consts["g_cutoff"])
               & (alpha > consts["alpha_threshold"])
               & (t_star > consts["t_min"]) & (t_star < hi.to(dtype)[ray]))
        found.append((ray[acc], t_star[acc], j[acc], alpha[acc]))
    if not found:
        e = torch.zeros(0, dtype=torch.long, device=o.device)
        return e, torch.zeros(0, dtype=dtype, device=o.device), e, \
            torch.zeros(0, dtype=dtype, device=o.device)
    ray, t, j, a = (torch.cat(x) for x in zip(*found))
    s = torch.argsort(sp.index[j], stable=True)
    s = s[torch.argsort(t[s].float(), stable=True)]
    s = s[torch.argsort(ray[s], stable=True)]
    return ray[s], t[s], j[s], a[s]


def segment(sp: Splats, o, d, hi, consts: dict, *, dtype=torch.float32):
    """(trans [P], color [P, 3], hits [P]) of the splats along rays (o, d)
    [P, 3] (any length: t is the ray parameter) in (t_min, hi [P]), by
    the k-buffer passes of `splat_rt.py`."""
    dev = o.device
    P = o.shape[0]
    trans = torch.ones(P, dtype=dtype, device=dev)
    color = torch.zeros((P, 3), dtype=dtype, device=dev)
    hits = torch.zeros(P, dtype=torch.long, device=dev)
    for b0 in range(0, P, BLOCK_RAYS):
        b1 = min(P, b0 + BLOCK_RAYS)
        ray, t, j, a = _hits(sp, o[b0:b1], d[b0:b1], hi[b0:b1], consts,
                             dtype)
        trans[b0:b1], color[b0:b1], hits[b0:b1] = splat_rt._passes(
            ray, t, j, a, sp.colors, b1 - b0, consts, dtype, "depth")
    return trans, color, hits


def camera_rays(view, jitter, pixels, dtype=torch.float32):
    """Origins and directions [P, 3] of the camera rays of `pixels`
    (framebuffer indices), the frame's jitter [W·H, 2] added to the
    pixels' corners, as `pathtrace.camera_rays` defines them, but rounded
    as the program forms them: the camera-space direction over its
    `torch.linalg.norm`, then one [3, 3] × [3, W·H] product for the whole
    frame. The ray-space response's g cancels terms of |m|²/σ² (~1e6 for
    the cell's splats seen from the orbit), so an ulp of direction moves
    it by up to ~0.1: on the camera rays, whose every splat hit the check
    compares, the reference keeps the program's rounding, as `splat_rt.py`
    keeps the kernel's."""
    dev = jitter.device
    W, H = view.width, view.height
    c2w = torch.linalg.inv(torch.as_tensor(view.view, device=dev))
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    p = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float() + jitter
    k = {a: torch.tensor(np.float32(getattr(view, a)), device=dev)
         for a in ("fx", "fy", "cx", "cy")}
    d_cam = torch.stack([(p[:, 0] - k["cx"]) / k["fx"],
                         (p[:, 1] - k["cy"]) / k["fy"],
                         torch.ones(W * H, device=dev)], -1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    d = (c2w[:3, :3] @ d_cam.T).T[pixels]
    o = c2w[:3, 3].expand_as(d)
    return o.to(dtype), d.to(dtype)


def sky(d):
    """The miss shader's sky of directions d [P, 3] (any length)."""
    nn = torch.sqrt((d[:, 0] * d[:, 0] + d[:, 2] * d[:, 2])
                    + d[:, 1] * d[:, 1])
    ts = 0.5 * (d[:, 1] / torch.clamp_min(nn, 1e-9) + 1.0)
    one_m = (1.0 - ts) * 1.0
    return torch.stack([one_m + ts * c for c in SKY_TOP], -1)


def trace(sc: pathtrace.Scene, sp: Splats, view, seed: int, pixels, *,
          bounces: int, t_min: float, t_max: float, consts: dict,
          has_sky: bool = True, dtype=torch.float32,
          window: bool = True) -> dict:
    """The hybrid path trace of `pixels` ([P] framebuffer indices) of the
    frame drawn from `seed`: color [P, 3] (float32, linear), primary [P]
    (the bounce-0 triangle, -1 on a miss), hits [P] (the splats bounce
    0's segment blended), splat_hits [P] (those of every segment) and
    segments [P] (the segments traced). consts is
    `splat_rt.constants(render)` with t_min and t_max the path's."""
    dev = sc.v0.device
    W, H = view.width, view.height
    pixels = torch.as_tensor(pixels, device=dev).long()
    dr = pathtrace.draws(seed, W * H, bounces, dev)
    o, d = camera_rays(view, dr["jitter"], pixels, dtype)
    units = [u[pixels].to(dtype) for u in dr["unit"]]
    unis = [u[pixels].to(dtype) for u in dr["uniform"]]
    del dr
    P = pixels.shape[0]
    color = torch.zeros((P, 3), dtype=dtype, device=dev)
    through = torch.ones((P, 3), dtype=dtype, device=dev)
    out = {"primary": torch.full((P,), -1, dtype=torch.long, device=dev),
           "hits": torch.zeros(P, dtype=torch.long, device=dev),
           "splat_hits": torch.zeros(P, dtype=torch.long, device=dev),
           "segments": torch.zeros(P, dtype=torch.long, device=dev)}
    live = torch.arange(P, device=dev)          # the paths still going
    t_seg = min(t_max, consts["t_max"])
    for b in range(bounces):
        if live.numel() == 0:
            break
        t, tri = pathtrace.nearest_hit(sc, o, d, t_min, t_max)
        hit = tri >= 0
        hi = torch.full_like(t, t_seg, dtype=torch.float32)
        if window:
            hi = torch.where(hit, torch.clamp_max(t.float(), t_seg), hi)
        g_trans, g_color, g_hits = segment(sp, o, d, hi, consts,
                                           dtype=dtype)
        if b == 0:
            out["primary"], out["hits"] = tri, g_hits
        out["splat_hits"][live] += g_hits
        out["segments"][live] += 1
        color[live] = color[live] + through[live] * g_color
        through[live] = through[live] * g_trans[:, None]
        if has_sky:
            gone = live[~hit]
            color[gone] = color[gone] + through[gone] * sky(d[~hit])
        live, o, d, t, tri = live[hit], o[hit], d[hit], t[hit], tri[hit]
        n = pathtrace._normalise(pathtrace._cross(sc.e1[tri], sc.e2[tri]))
        n = torch.where((pathtrace._dot(n, d) > 0)[:, None], -n, n)
        m = sc.mat[tri]
        albedo = sc.albedo[m]
        atten, new_d, go, light = pathtrace.scatter(
            sc.model[m], albedo, sc.fuzz[m], sc.ior[m], d, n,
            units[b][live], unis[b][live])
        color[live] = color[live] + torch.where(
            light[:, None], through[live] * albedo, 0.0)
        through[live] = through[live] * atten
        live, o, d = live[go], (o + t[:, None] * d)[go], new_d[go]
    out["color"] = color.float()
    return out

