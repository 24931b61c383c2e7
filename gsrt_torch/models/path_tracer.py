"""Wavefront path tracer over mixed primitive scenes (counterpart of
`gsrt.models.path_tracer`).

All rays advance one bounce per step as dense [R] tensors with masked
lanes; materials are evaluated for every lane and selected by mask. Three
renders, as `gsrt cli bench` runs them: `render_path_traced` (PT),
`render_shadow_rays` (SH) and `render_ambient_occlusion` (AO); and
`render_foveated`, PT with per-pixel sample counts by ring.

Spheres, boxes, capped y-axis cylinders and Mandelbulbs are swept brute
force, in chunks of at most SWEEP_PAIRS (ray, primitive) pairs, so a
scene of thousands of boxes fits the card; the first nearest primitive
wins, as one `argmin` over all of them picks it. Triangles go through the
packed-cluster traversal (`ops.tri_kernel`, the CUDA kernel
`csrc/tri_kernel.cu`) once `with_tri_table` has attached its table, else
the Morton-cluster bundle traversal once `with_tri_clusters` has attached
its clusters (`ops.clusters`), else the chunked Möller–Trumbore sweep.
The path tracer's waves after bounce 0 scatter in every direction: with
a table they walk its per-ray tree instead (`ops.tri_bvh`, the CUDA
kernel `csrc/tri_bvh.cu`).
Bounce 0 of a pinhole camera over a triangle scene without cutouts takes
the screen-tile binned cast (`ops.tri_binning`, the CUDA kernel
`csrc/tri_cast.cu`) when primary_impl is "auto" or "binned". Occlusion
rays run the traversal in any-hit mode (cutouts ignored, as in the JAX
package); bounce waves and AO rays are coherence sorted and retired rays
parked outside the scene first.

Materials may carry a texture (`textures`, sampled bilinearly at the
hit's triangle texcoords or the sphere UV of its normal, or trilinearly
by ray-cone LOD once `with_texture_mips` has attached a pyramid) and a
cutout mask (`alpha_textures`): a PT hit whose alpha is below 0.5 is
skipped by re-tracing past it, at most `max_skips` times.

Each bounce wave is shaded (the sky, the scatter of the four material
models, the light, the throughput and the next segment) by
`ops.pt_shade.shade_wave`: one launch of the CUDA kernel
`csrc/pt_shade.cu` on the card, `_shade_plain` (the same ops in PyTorch,
through `_sky` and `_scatter`) on the CPU.

Random draws come from a `torch.Generator` seeded with `seed`, through
`_uniform`, `_random_unit` and `_random_in_unit_disk`; the JAX package
draws with `jax.random`, so the two packages' noise differs for the same
seed. The JAX package's `lax.map` over samples, `fori_loop` over bounces
and `while_loop` over cutout skips are Python loops here.

Splats share the scene with the primitives (`render_path_traced`'s
`gaussians`, with or without `gauss_tree`, or `gauss_clusters`): every
bounce segment composites through them by the k-buffer passes of
`models.gaussian_rt`, the per-ray splat tree (`ops.splat_bvh`, the CUDA
kernel `csrc/splat_bvh.cu`) or `ops.splat_clusters`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import Camera, Materials
from gsrt_torch.ops.primitives import (_dot, _norm, _sqrt, box_normal,
                                       cylinder_normal, mandelbulb_normal,
                                       ray_box, ray_cylinder, ray_mandelbulb,
                                       ray_sphere, ray_triangle,
                                       sphere_normal, triangle_normal)
from gsrt_torch import _kernels
from gsrt_torch.ops.pt_shade import shade_wave
from gsrt_torch.utils.profiling import TRACER

SWEEP_PAIRS = 1 << 25   # (ray, primitive) pairs a chunk of a sweep


class PrimitiveScene(NamedTuple):
    """Mixed-primitive scene, the JAX package's fields: spheres, boxes,
    triangles (with optional per-corner texcoords), capped y-axis
    cylinders and Mandelbulbs (None when absent), the material table, an
    optional texture atlas [NT, TH, TW, 3] with cutout masks [NT, TH, TW],
    and the acceleration structures and mip pyramid the `with_*`
    functions attach."""

    sph_center: torch.Tensor   # [S, 3]
    sph_radius: torch.Tensor   # [S]
    sph_mat: torch.Tensor      # [S] int32
    box_min: torch.Tensor      # [B, 3]
    box_max: torch.Tensor      # [B, 3]
    box_mat: torch.Tensor      # [B]
    tri_v0: torch.Tensor       # [T, 3]
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_mat: torch.Tensor      # [T]
    materials: Materials
    textures: Optional[torch.Tensor] = None        # [NT, TH, TW, 3]
    alpha_textures: Optional[torch.Tensor] = None  # [NT, TH, TW]
    tri_uv0: Optional[torch.Tensor] = None         # [T, 2]
    tri_uv1: Optional[torch.Tensor] = None
    tri_uv2: Optional[torch.Tensor] = None
    tri_clusters: Optional[object] = None          # ops.clusters.TriClusters
    tri_table: Optional[object] = None             # ops.tri_kernel.TriTable
    cyl_center: Optional[torch.Tensor] = None      # [C, 3]
    cyl_radius: Optional[torch.Tensor] = None      # [C]
    cyl_half_h: Optional[torch.Tensor] = None      # [C]
    cyl_mat: Optional[torch.Tensor] = None         # [C] int32
    mnd_center: Optional[torch.Tensor] = None      # [M, 3]
    mnd_radius: Optional[torch.Tensor] = None      # [M]
    mnd_mat: Optional[torch.Tensor] = None         # [M] int32
    tex_mips: Optional[torch.Tensor] = None        # [NT, TH, TW + TW//2, 3]
    mat_texel: Optional[torch.Tensor] = None       # [n_mats] texels/unit

    @property
    def counts(self):
        return (self.sph_center.shape[0], self.box_min.shape[0],
                self.tri_v0.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device


def sphere_uv(normal):
    """Equirectangular UV of a unit surface normal."""
    u = 0.5 + torch.atan2(normal[:, 2], normal[:, 0]) / (2 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(normal[:, 1], -1, 1)) / math.pi
    return torch.stack([u, v], -1)


def sample_texture(textures, tex_id, uv):
    """Bilinear atlas sample with clamp-to-edge addressing: textures [NT,
    TH, TW, 3], tex_id [R] (-1 → white), uv [R, 2]."""
    NT, TH, TW, _ = textures.shape
    t = torch.clamp(tex_id, 0, NT - 1).long()
    u = torch.clamp(uv[:, 0], 0.0, 1.0) * (TW - 1)
    v = torch.clamp(uv[:, 1], 0.0, 1.0) * (TH - 1)
    x0 = torch.floor(u).to(torch.int32).clamp_min(0)
    y0 = torch.floor(v).to(torch.int32).clamp_min(0)
    x1 = torch.clamp_max(x0 + 1, TW - 1)
    y1 = torch.clamp_max(y0 + 1, TH - 1)
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]
    x0, y0, x1, y1 = x0.long(), y0.long(), x1.long(), y1.long()
    c00, c01 = textures[t, y0, x0], textures[t, y0, x1]
    c10, c11 = textures[t, y1, x0], textures[t, y1, x1]
    col = ((1 - fy) * ((1 - fx) * c00 + fx * c01)
           + fy * ((1 - fx) * c10 + fx * c11))
    return torch.where((tex_id >= 0)[:, None], col, torch.ones_like(col))


def with_tri_clusters(scene: PrimitiveScene, k: int = 64,
                      sup: int = 8) -> PrimitiveScene:
    """Attach the Morton-cluster bundle traversal's clusters of the
    scene's triangles (`ops.clusters`); once per scene. Meshes under 2·k
    triangles keep the brute-force sweep."""
    from gsrt_torch.ops.clusters import build_tri_clusters
    if scene.tri_v0.shape[0] < 2 * k:
        return scene
    return scene._replace(tri_clusters=build_tri_clusters(
        scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_mat,
        scene.tri_uv0, scene.tri_uv1, scene.tri_uv2, k=k, sup=sup))


def with_texture_mips(scene: PrimitiveScene) -> PrimitiveScene:
    """Attach a mip pyramid of the textures and each material's texel
    density (the mean over its triangles) for ray-cone LOD sampling; once
    per scene, a no-op without textures, texcoords or texture ids. The
    densities are summed per material on the host in triangle order (f32,
    `np.add.at`), as the JAX package's scatter-add sums them."""
    if scene.textures is None or scene.tri_uv0 is None or \
            scene.materials.texture_id is None:
        return scene
    from gsrt_torch.ops.mip import build_mip_atlas, triangle_texel_density
    mip = build_mip_atlas(scene.textures)
    dens = triangle_texel_density(
        scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_uv0,
        scene.tri_uv1, scene.tri_uv2, mip.base_w).cpu().numpy()
    mat = scene.tri_mat.cpu().numpy()
    n_mats = scene.materials.diffuse.shape[0]
    cnt = np.zeros(n_mats, np.float32)
    tot = np.zeros(n_mats, np.float32)
    np.add.at(cnt, mat, np.float32(1.0))
    np.add.at(tot, mat, dens)
    mat_texel = tot / np.maximum(cnt, np.float32(1.0))
    return scene._replace(tex_mips=mip.data, mat_texel=torch.as_tensor(
        mat_texel, device=scene.device))


def _mip_from_packed(data):
    """The MipAtlas view of a packed pyramid: its base width is 2/3 of the
    packed width, and every offset follows."""
    from gsrt_torch.ops.mip import MipAtlas
    th = data.shape[1]
    tw = (data.shape[2] * 2) // 3
    n_levels = 1 + max(min(th, tw).bit_length() - 1, 0)
    return MipAtlas(data=data, n_levels=n_levels, base_h=th, base_w=tw)


def with_tri_table(scene: PrimitiveScene,
                   min_tris: int = 256) -> PrimitiveScene:
    """Attach the packed-cluster table of the traversal kernel and the
    per-ray tree over its slots (`ops.tri_bvh`); once per scene. Meshes
    under min_tris triangles keep the brute-force sweep."""
    from gsrt_torch.ops.tri_bvh import build_tri_bvh
    from gsrt_torch.ops.tri_kernel import build_tri_table
    if scene.tri_v0.shape[0] < min_tris:
        return scene
    tt = build_tri_table(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    return scene._replace(tri_table=tt._replace(bvh=build_tri_bvh(tt)))


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)


def _barycentric(orig, dirn, v0, v1, v2):
    """(u, v) of each ray's own triangle, elementwise Möller–Trumbore."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(dirn, e2)
    det = _dot(e1, pvec)
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, torch.zeros_like(det))
    tvec = orig - v0
    u = _dot(tvec, pvec) * inv_det
    v = _dot(dirn, _cross(tvec, e1)) * inv_det
    return u, v


def _sweep(test, n: int, R: int):
    """The nearest of n primitives for R rays, in chunks of at most
    SWEEP_PAIRS (ray, primitive) pairs: test(s, e) → (t [R, e - s],
    *fields [R, e - s]). Returns (i [R], [t, *fields] at i). Inside a
    chunk `argmin` takes the first minimum; a later chunk replaces it only
    where strictly nearer, so i is the unchunked argmin's."""
    step = max(1, SWEEP_PAIRS // max(R, 1))
    best = best_i = None
    for s in range(0, n, step):
        out = test(s, min(n, s + step))
        k = out[0].argmin(-1)
        got = [torch.gather(a, -1, k[:, None])[:, 0] for a in out]
        if best is None:
            best, best_i = got, k
            continue
        upd = got[0] < best[0]
        best = [torch.where(upd, g, b) for g, b in zip(got, best)]
        best_i = torch.where(upd, k + s, best_i)
    return best_i, best


def _closest_hit(scene: PrimitiveScene, orig, dirn, t_min, t_max,
                 tri_override=None, any_hit: bool = False,
                 tri_id: bool = False, per_ray: bool = False):
    """Nearest hit over every primitive type: (t [R], normal [R, 3],
    mat_id [R], hit [R], uv [R, 2] or None, ovf [] bool). uv is the
    texcoord at the hit when the mesh has texcoords (the sphere UV of the
    normal off triangles). any_hit relaxes the table traversal to
    occlusion (consume `hit` alone). ovf is the traversal's visit-list
    truncation. per_ray walks the table's per-ray tree (`ops.tri_bvh`,
    the closest hit, no visit list: ovf stays False) in place of the
    block traversal: the path tracer's scattered waves take it.
    tri_override = (t [R], tri_id [R]) from the binned primary cast
    replaces the triangle search; misses are (3.4e38-class t,
    _ID_SENTINEL). Triangles take the first of tri_override, tri_table,
    tri_clusters and the sweep that the scene has. tri_id appends [R]
    int64: the scene index of the triangle that is the nearest hit, -1
    where the nearest hit is no triangle or there is none (not with
    tri_clusters, which keep no index)."""
    R = orig.shape[0]
    dev = orig.device
    best_t = torch.full((R,), float("inf"), device=dev)
    best_n = torch.zeros((R, 3), device=dev)
    best_m = torch.zeros((R,), dtype=torch.int32, device=dev)
    best_uv = torch.zeros((R, 2), device=dev) \
        if scene.tri_uv0 is not None else None
    ovf = torch.zeros((), dtype=torch.bool, device=dev)

    def take(ti, n, mat, uv=None):
        nonlocal best_t, best_n, best_m, best_uv
        upd = ti < best_t
        best_t = torch.where(upd, ti, best_t)
        best_n = torch.where(upd[:, None], n, best_n)
        best_m = torch.where(upd, mat.to(torch.int32), best_m)
        if best_uv is not None:
            best_uv = torch.where(upd[:, None],
                                  sphere_uv(n) if uv is None else uv,
                                  best_uv)
        return upd

    def nearest(fn, n):
        i, (ti,) = _sweep(lambda s, e: (fn(slice(s, e)),), n, R)
        return ti, i, orig + ti[:, None] * dirn

    if scene.sph_center.shape[0]:
        ti, i, hit_p = nearest(lambda c: ray_sphere(
            orig, dirn, scene.sph_center[c], scene.sph_radius[c], t_min,
            t_max), scene.sph_center.shape[0])
        take(ti, sphere_normal(hit_p, scene.sph_center[i]),
             scene.sph_mat[i])
    if scene.box_min.shape[0]:
        ti, i, hit_p = nearest(lambda c: ray_box(
            orig, dirn, scene.box_min[c], scene.box_max[c], t_min, t_max),
            scene.box_min.shape[0])
        take(ti, box_normal(hit_p, scene.box_min[i], scene.box_max[i]),
             scene.box_mat[i])
    if scene.cyl_center is not None and scene.cyl_center.shape[0]:
        ti, i, hit_p = nearest(lambda c: ray_cylinder(
            orig, dirn, scene.cyl_center[c], scene.cyl_radius[c],
            scene.cyl_half_h[c], t_min, t_max), scene.cyl_center.shape[0])
        take(ti, cylinder_normal(hit_p, scene.cyl_center[i],
                                 scene.cyl_radius[i], scene.cyl_half_h[i]),
             scene.cyl_mat[i])
    if scene.mnd_center is not None and scene.mnd_center.shape[0]:
        ti, i, hit_p = nearest(lambda c: ray_mandelbulb(
            orig, dirn, scene.mnd_center[c], scene.mnd_radius[c], t_min,
            t_max), scene.mnd_center.shape[0])
        # the gradient at the centre-relative point, unscaled, as the
        # march evaluates the estimate
        take(ti, mandelbulb_normal(hit_p - scene.mnd_center[i]),
             scene.mnd_mat[i])

    if not scene.tri_v0.shape[0]:
        out = best_t, best_n, best_m, torch.isfinite(best_t), best_uv, ovf
        return out + (torch.full((R,), -1, dtype=torch.int64, device=dev),) \
            if tri_id else out
    if tri_id and tri_override is None and scene.tri_table is None and \
            scene.tri_clusters is not None:
        raise ValueError("tri_clusters keep no triangle index")
    u = v = None
    if tri_override is not None:
        from gsrt_torch.ops.tri_binning import _ID_SENTINEL
        ti_raw, i = tri_override
        miss = i == _ID_SENTINEL
        i = torch.clamp_max(i, scene.tri_v0.shape[0] - 1).long()
        ti = torch.where(miss, torch.full_like(ti_raw, float("inf")), ti_raw)
        v0, v1, v2 = scene.tri_v0[i], scene.tri_v1[i], scene.tri_v2[i]
        mat, uvs = scene.tri_mat[i], (scene.tri_uv0, scene.tri_uv1,
                                      scene.tri_uv2)
    elif scene.tri_table is not None:
        tt = scene.tri_table
        if per_ray:
            from gsrt_torch.ops.tri_bvh import closest_hit_bvh
            if any_hit:
                raise ValueError("the per-ray tree takes closest hits only")
            counts = (torch.zeros(3, dtype=torch.int64, device=dev)
                      if orig.is_cuda and TRACER.recording() else None)
            ti, slot, _ = closest_hit_bvh(tt, orig, dirn, t_min, t_max,
                                          counts=counts)
            if counts is not None:
                TRACER.count(tri_nodes=counts[0], tri_tests=counts[1],
                             tri_rays=counts[2])
        else:
            from gsrt_torch.ops.tri_kernel import closest_hit_packed
            ti, slot, _, plan = closest_hit_packed(tt, orig, dirn, t_min,
                                                   t_max, any_hit=any_hit)
            ovf = ovf | plan.overflow
            TRACER.count(tri_visits=plan.total,
                         tri_blocks=plan.block_start.shape[0] - 1)
        i = tt.order[slot.long()].long()
        v0, v1, v2 = scene.tri_v0[i], scene.tri_v1[i], scene.tri_v2[i]
        mat, uvs = scene.tri_mat[i], (scene.tri_uv0, scene.tri_uv1,
                                      scene.tri_uv2)
    elif scene.tri_clusters is not None:
        from gsrt_torch.ops.clusters import closest_hit_tri_clusters
        tc = scene.tri_clusters
        ti, bc, bk, _, _, _ = closest_hit_tri_clusters(tc, orig, dirn,
                                                       t_min, t_max)
        i = (bc.long(), bk.long())
        v0, v1, v2 = tc.v0[i], tc.v1[i], tc.v2[i]
        mat, uvs = tc.mat[i], (tc.uv0, tc.uv1, tc.uv2)
    else:
        i, (ti, u, v) = _sweep(lambda s, e: ray_triangle(
            orig, dirn, scene.tri_v0[s:e], scene.tri_v1[s:e],
            scene.tri_v2[s:e], t_min, t_max), scene.tri_v0.shape[0], R)
        v0, v1, v2 = scene.tri_v0[i], scene.tri_v1[i], scene.tri_v2[i]
        mat, uvs = scene.tri_mat[i], (scene.tri_uv0, scene.tri_uv1,
                                      scene.tri_uv2)
    n = triangle_normal(v0, v1, v2)
    n = torch.where(_dot(n, dirn)[:, None] > 0, -n, n)     # face forward
    uv = None
    if best_uv is not None:
        if u is None:
            u, v = _barycentric(orig, dirn, v0, v1, v2)
        w = 1.0 - u - v
        uv = (w[:, None] * uvs[0][i] + u[:, None] * uvs[1][i]
              + v[:, None] * uvs[2][i])
    upd = take(ti, n, mat, uv)
    out = best_t, best_n, best_m, torch.isfinite(best_t), best_uv, ovf
    return out + (torch.where(upd, i, -1),) if tri_id else out


def _sample_alpha(scene: PrimitiveScene, mat_id, normal, uv=None):
    """Cutout alpha at the hit (1 = opaque), the nearest texel of the
    material's mask at the hit's texcoords (the sphere UV of the normal
    without them)."""
    if scene.alpha_textures is None or scene.materials.texture_id is None:
        return torch.ones(mat_id.shape[0], device=mat_id.device)
    if uv is None:
        uv = sphere_uv(normal)
    NT, TH, TW = scene.alpha_textures.shape
    tex_id = scene.materials.texture_id[mat_id.long()]
    t = torch.clamp(tex_id, 0, NT - 1).long()
    x = torch.clamp(uv[:, 0] * (TW - 1), 0, TW - 1).to(torch.int32)
    y = torch.clamp(uv[:, 1] * (TH - 1), 0, TH - 1).to(torch.int32)
    a = scene.alpha_textures[t, y.clamp_min(0).long(), x.clamp_min(0).long()]
    return torch.where(tex_id >= 0, a, torch.ones_like(a))


def _closest_hit_cutout(scene: PrimitiveScene, orig, dirn, t_min, t_max,
                        max_skips: int = 3, retraced: list | None = None,
                        per_ray: bool = False):
    """Closest hit honouring alpha cutouts: a hit whose alpha is below 0.5
    is skipped by tracing the ray again from t + 1e-3, every ray of the
    bundle each time (as the JAX package's `while_loop`), at most
    max_skips + 1 traces, ending early once every ray has settled. Rays
    still cut after the last trace report no hit. `retraced`, where given,
    receives the number of rays cut by each trace; per_ray is
    `_closest_hit`'s."""
    if scene.alpha_textures is None:
        return _closest_hit(scene, orig, dirn, t_min, t_max,
                            per_ray=per_ray)
    R = orig.shape[0]
    dev = orig.device
    tmin_cur = torch.as_tensor(t_min, dtype=torch.float32,
                               device=dev).reshape(-1, 1).expand(R, 1)
    bt = torch.full((R,), float("inf"), device=dev)
    bn = torch.zeros((R, 3), device=dev)
    bm = torch.zeros((R,), dtype=torch.int32, device=dev)
    bhit = torch.zeros((R,), dtype=torch.bool, device=dev)
    buv = torch.zeros((R, 2), device=dev)
    done = torch.zeros((R,), dtype=torch.bool, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_skips + 1):
        t, n, m, hit, uv, ovf_i = _closest_hit(scene, orig, dirn, tmin_cur,
                                               t_max, per_ray=per_ray)
        cut = hit & (_sample_alpha(scene, m, n, uv) < 0.5) & ~done
        settle = ~done & ~cut
        bt = torch.where(settle, t, bt)
        bn = torch.where(settle[:, None], n, bn)
        bm = torch.where(settle, m, bm)
        bhit = torch.where(settle, hit, bhit)
        if uv is not None:
            buv = torch.where(settle[:, None], uv, buv)
        done = done | settle
        tmin_cur = torch.where(cut[:, None], t[:, None] + 1e-3, tmin_cur)
        ovf = ovf | ovf_i
        if retraced is not None:
            retraced.append(int(cut.sum()))
        if bool(done.all()):
            break
    return (bt, bn, bm, bhit & done,
            buv if scene.tri_uv0 is not None else None, ovf)


def _scene_sort_bounds(scene, gauss_clusters=None, gauss_tree=None):
    """(lo, hi, park_o, park_d) for coherence sorting, or (None,) * 4
    without a triangle table, splat clusters or a splat tree. lo, hi
    bound the table's and the clusters' super-cluster boxes and the
    tree's root box; retired rays are parked at park_o, outside all of
    them, all along park_d, so blocks of them plan no visits and their
    walks miss every root."""
    boxes = []
    if scene.tri_table is not None:
        boxes.append((scene.tri_table.sup_min, scene.tri_table.sup_max))
    if gauss_clusters is not None:
        cl = gauss_clusters.clusters
        boxes.append((cl.sup_min, cl.sup_max))
    if gauss_tree is not None and gauss_tree.n_leaves:
        rb = gauss_tree.root_box
        boxes.append((rb[None, :3], rb[None, 3:]))
    if not boxes:
        return None, None, None, None
    lo = torch.stack([b[0].amin(0) for b in boxes]).amin(0)
    hi = torch.stack([b[1].amax(0) for b in boxes]).amax(0)
    park_o = hi + (hi - lo) + 1.0
    park_d = torch.full((3,), 1.0 / math.sqrt(3.0), device=lo.device)
    return lo, hi, park_o, park_d


def _coherence_perm(orig, dirn, live, lo, hi):
    """Rays grouped by origin Morton cell (18 bits) then direction Morton
    code (9 bits), retired rays last. Returns (perm, inv)."""
    from gsrt_torch.ops.morton import morton3d
    om = morton3d(orig, lo, hi) >> 12
    one = torch.ones(3, device=orig.device)
    dm = morton3d(dirn, -one, one) >> 21
    key = torch.where(live, (om << 9) | dm, torch.full_like(om, 0x7FFFFFFF))
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def _any_hit(scene: PrimitiveScene, orig, dirn, t_min, t_max, live=None,
             sort: bool = True):
    """Occlusion query: (hit [R], ovf). Rays not `live` are parked outside
    the scene; `sort` coherence-sorts the wavefront first (AO rays; shadow
    rays are coherent already)."""
    if scene.tri_table is not None:
        lo, hi, park_o, park_d = _scene_sort_bounds(scene)
        if live is None:
            live = torch.ones((orig.shape[0],), dtype=torch.bool,
                              device=orig.device)
        if sort:
            perm, inv = _coherence_perm(orig, dirn, live, lo, hi)
            live_s = live[perm][:, None]
            o_s = torch.where(live_s, orig[perm], park_o)
            d_s = torch.where(live_s, dirn[perm], park_d)
            tb = t_max[perm] if getattr(t_max, "ndim", 0) >= 1 else t_max
            _, _, _, hit, _, ovf = _closest_hit(scene, o_s, d_s, t_min, tb,
                                                any_hit=True)
            return hit[inv], ovf
        o_s = torch.where(live[:, None], orig, park_o)
        d_s = torch.where(live[:, None], dirn, park_d)
        _, _, _, hit, _, ovf = _closest_hit(scene, o_s, d_s, t_min, t_max,
                                            any_hit=True)
        return hit, ovf
    _, _, _, hit, _, ovf = _closest_hit(scene, orig, dirn, t_min, t_max)
    return hit, ovf


# --- random draws: the only places the renders take random numbers ---

def _uniform(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _random_unit(gen, shape):
    v = torch.randn(shape, generator=gen, device=gen.device)
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-9)


def _random_in_unit_disk(gen, n):
    r = torch.sqrt(_uniform(gen, (n,)))
    th = _uniform(gen, (n,)) * 2 * math.pi
    return torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)


def _reflect(d, n):
    return d - 2.0 * _dot(d, n)[:, None] * n


def _refract(d, n, eta):
    """glsl refract(); 0 on total internal reflection."""
    cos_i = -_dot(d, n)[:, None]
    k = 1.0 - eta ** 2 * (1.0 - cos_i ** 2)
    refr = eta * d + (eta * cos_i - _sqrt(torch.clamp_min(k, 0.0))) * n
    return torch.where(k >= 0, refr, torch.zeros_like(refr))


def _schlick(cosine, ref_idx):
    r0 = ((1 - ref_idx) / (1 + ref_idx)) ** 2
    return r0 + (1 - r0) * (1 - cosine) ** 5


def _sky(dirn, has_sky: bool):
    """The miss shader's sky gradient (black without a sky)."""
    t = 0.5 * (dirn[:, 1] / torch.clamp_min(torch.linalg.norm(dirn, dim=-1),
                                            1e-9) + 1.0)
    top = torch.tensor([0.5, 0.7, 1.0], device=dirn.device)
    sky = (1 - t[:, None]) * torch.ones(3, device=dirn.device) \
        + t[:, None] * top
    return sky if has_sky else torch.zeros_like(sky)


def _unit_rays(dirn):
    """Each ray's direction over its own length."""
    return dirn / torch.clamp_min(_norm(dirn, keepdim=True), 1e-9)


def _scatter(gen, mats: Materials, mat_id, dirn, normal, hit_p=None,
             tex_color=None):
    """All four scatter models evaluated dense and selected by material,
    on each ray's direction over its own length, as RayTracingInVulkan's
    scatter shaders normalise it (the JAX package divides every direction
    by one norm of the whole batch: ROADMAP.md Queue 3). Every dot product
    is summed left to right per ray, so a ray's result does not depend on
    its batch. tex_color [R, 3] scales the diffuse albedo and tints glass;
    hit_p, the hit points, is taken as the JAX package takes it (no model
    reads it). Returns (attenuation [R, 3], new_dir [R, 3], scattered
    [R], emitted [R])."""
    R = dirn.shape[0]
    mat_id = mat_id.long()
    model = mats.model[mat_id]
    diffuse = mats.diffuse[mat_id]
    if tex_color is not None:
        diffuse = diffuse * tex_color
    fuzz = mats.fuzziness[mat_id]
    ref_idx = mats.refraction_index[mat_id]
    d = _unit_rays(dirn)
    rand_unit = _random_unit(gen, (R, 3))

    lam_dir = normal + rand_unit
    lam_scattered = _dot(d, normal) < 0
    refl = _reflect(d, normal)
    met_dir = refl + fuzz[:, None] * rand_unit
    met_scattered = _dot(refl, normal) > 0
    dn = _dot(d, normal)[:, None]
    outward = torch.where(dn > 0, -normal, normal)
    front = dn[:, 0] > 0
    eta = torch.where(front, ref_idx, 1.0 / ref_idx)
    cosine = torch.where(front, ref_idx * dn[:, 0], -dn[:, 0])
    refr = _refract(d, outward, eta[:, None])
    tir = _dot(refr, refr) == 0
    reflect_prob = torch.where(tir, torch.ones_like(cosine),
                               _schlick(cosine, ref_idx))
    die_reflects = _uniform(gen, (R,)) < reflect_prob
    die_dir = torch.where(die_reflects[:, None], _reflect(d, normal), refr)

    is_lam = (model == Materials.LAMBERTIAN)[:, None]
    is_met = (model == Materials.METALLIC)[:, None]
    is_die = (model == Materials.DIELECTRIC)[:, None]
    is_iso = model == Materials.ISOTROPIC
    is_light = model == Materials.DIFFUSE_LIGHT
    new_dir = torch.where(is_lam, lam_dir, torch.where(
        is_met, met_dir, torch.where(is_die, die_dir, rand_unit)))
    atten = torch.where(is_die, torch.ones_like(diffuse)
                        if tex_color is None else tex_color, diffuse)
    scattered = torch.where(is_lam[:, 0], lam_scattered, torch.where(
        is_met[:, 0], met_scattered, is_die[:, 0] | is_iso))
    return atten, new_dir, scattered & ~is_light, is_light


def _shade_plain(gen, mats: Materials, t, n, mat, hit, orig, dirn, active,
                 ray_color, out_color, tex_color=None, has_sky: bool = False):
    """The shading of one bounce wave as plain tensor ops, drawing through
    `_scatter`: the sky of the rays that missed, the scatter, the light of
    those that hit a light, the throughput and the next segment. Returns
    new (orig, dirn, ray_color, out_color, active). `ops.pt_shade.
    shade_wave` takes it on CPU tensors; on CUDA tensors its kernel is
    bit-equal to it."""
    miss_now = (active & ~hit)[:, None]
    out_color = out_color + torch.where(
        miss_now, ray_color * _sky(dirn, has_sky), 0.0)
    hit_p = orig + t[:, None] * dirn
    atten, new_dir, scattered, is_light = _scatter(
        gen, mats, mat, dirn, n, hit_p, tex_color)
    light_now = (active & hit & is_light)[:, None]
    out_color = out_color + torch.where(
        light_now, ray_color * mats.diffuse[mat.long()], 0.0)
    ray_color = torch.where((active & hit)[:, None], ray_color * atten,
                            ray_color)
    orig = torch.where(hit[:, None], hit_p, orig)
    dirn = torch.where(hit[:, None], new_dir, dirn)
    return orig, dirn, ray_color, out_color, active & hit & scattered


def generate_camera_rays(gen, camera: Camera, cfg: RenderConfig,
                         aperture: float = 0.0, focus: float = 1.0):
    """Jittered primary rays with thin-lens defocus (+z forward):
    (orig [H·W, 3], dirn [H·W, 3])."""
    H, W = camera.height, camera.width
    R = H * W
    dev = camera.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    p = pix + _uniform(gen, (R, 2))
    dx = (p[:, 0] - camera.cx) / camera.fx
    dy = (p[:, 1] - camera.cy) / camera.fy
    target = torch.stack([dx * focus, dy * focus,
                          torch.full((R,), focus, device=dev)], -1)
    lens = (aperture * 0.5) * _random_in_unit_disk(gen, R)
    offset = torch.stack([lens[:, 0], lens[:, 1],
                          torch.zeros(R, device=dev)], -1)
    d_cam = target - offset
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    c2w = torch.linalg.inv(camera.view)
    orig = (c2w[:3, :3] @ offset.T).T + c2w[:3, 3]
    dirn = (c2w[:3, :3] @ d_cam.T).T
    return orig, dirn


def _resolve_primary(primary_impl: str, scene, aperture: float = 0.0) -> str:
    """"auto" is "binned" whenever the screen-tile cast applies (a shared
    ray origin, no cutouts, a triangle scene), else "block"."""
    if primary_impl != "auto":
        return primary_impl
    ok = (aperture == 0.0 and scene.alpha_textures is None
          and int(scene.tri_v0.shape[0]) > 0)
    return "binned" if ok else "block"


def _tri_binning(scene, camera, cfg, tri_max_pairs: int,
                 span_exact: bool = False):
    """The screen-tile binning of the scene's triangles for the binned
    primary cast (once per camera)."""
    from gsrt_torch.ops.tri_binning import build_tri_binning
    if scene.tri_v0.shape[0] == 0:
        raise ValueError("the binned primary cast needs triangles")
    return build_tri_binning(
        scene.tri_v0, scene.tri_v1, scene.tri_v2, camera,
        tile_w=cfg.tile_w, tile_h=cfg.tile_h, max_pairs=tri_max_pairs,
        span_exact=span_exact)


def _cast(binning, camera, cfg, dirn):
    """(t, tri_id) of one camera bundle through the binning: the
    tri_override of _closest_hit."""
    from gsrt_torch.ops.tri_binning import cast_primary
    t_bin, id_bin = cast_primary(
        binning, dirn, camera.position, width=camera.width,
        height=camera.height, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        t_min=cfg.t_min, t_max=cfg.t_max)
    return t_bin.reshape(-1), id_bin.reshape(-1)


def _splat_segment(cfg: RenderConfig, o, d, t, hit, live, *,
                   gaussians=None, colors=None, gauss_clusters=None,
                   gauss_tree=None, rb: int = 256, s_max: int = 48):
    """The splats along each ray's segment of a wave, from its origin to
    its surface hit (cfg.t_max where it hit nothing): (trans [R], color
    [R, 3], hits [R], overflow [] bool). With `gauss_tree` one
    `ops.splat_bvh.trace_gaussian_rays_bvh` call (one `csrc/splat_bvh.cu`
    launch on the card, the plain version on the CPU), the rays not
    `live` given an empty window (t_max = −inf), so they blend nothing
    and fetch no node record; it never overflows. Else the clustered
    route (`gauss_clusters`) or the brute force (`gaussians`), every ray
    windowed at its hit. Span `pt.splats`; counters `splat_rays`, the
    live rays, and on the card the tree kernel's `splat_nodes`,
    `splat_tests`, `splat_walks`, `splat_hits` and `splat_replays`."""
    from gsrt_torch.models.gaussian_rt import trace_gaussian_rays
    from gsrt_torch.ops.splat_bvh import trace_gaussian_rays_bvh
    from gsrt_torch.ops.splat_clusters import trace_gaussian_rays_clustered
    seg_tmax = torch.where(hit, t, torch.full_like(t, cfg.t_max))
    no_ovf = torch.zeros((), dtype=torch.bool, device=o.device)
    with TRACER.span("pt.splats"):
        if TRACER.recording():
            TRACER.count(splat_rays=live.sum())
        if gauss_tree is not None:
            seg_tmax = torch.where(live, seg_tmax,
                                   torch.full_like(t, -math.inf))
            counts = (torch.zeros(5, dtype=torch.int64, device=o.device)
                      if o.is_cuda and TRACER.recording() else None)
            trans, color, hits, _ = trace_gaussian_rays_bvh(
                gauss_tree, o, d, cfg, colors, t_max=seg_tmax,
                counts=counts)
            if counts is not None:
                TRACER.count(splat_nodes=counts[0], splat_tests=counts[1],
                             splat_walks=counts[2], splat_hits=counts[3],
                             splat_replays=counts[4])
            return trans, color, hits, no_ovf
        if gauss_clusters is not None:
            return trace_gaussian_rays_clustered(
                gauss_clusters, o, d, cfg, t_max=seg_tmax, rb=rb,
                s_max=s_max)
        trans, color, hits = trace_gaussian_rays(gaussians, o, d, cfg,
                                                 colors=colors,
                                                 t_max=seg_tmax)
        return trans, color, hits, no_ovf


def render_path_traced(scene: PrimitiveScene, camera: Camera,
                       cfg: RenderConfig, seed: int = 0,
                       aperture: float = 0.0, focus: float = 1.0,
                       gaussians=None, gauss_clusters=None,
                       gauss_s_max: int = 48, gauss_rb: int = 256,
                       gauss_tree=None,
                       primary_impl: str = "auto",
                       tri_max_pairs: int = 1 << 20,
                       tri_span_exact: bool = False,
                       sort_bounces: bool = True,
                       return_flags: bool = False,
                       primary_ids: list | None = None,
                       primary_splat_hits: list | None = None):
    """Full path trace: [H, W, 3] linear colour, square-rooted under
    cfg.gamma_correction. return_flags adds {"tri_visits_overflow",
    "gauss_visits_overflow", "binned_pairs_overflow"}: a True flag means
    the image may miss geometry. With a triangle table or splat clusters
    each bounce wave is coherence-sorted and its retired rays parked
    (output-identical; sort_bounces=False traces the waves unsorted).
    primary_impl "binned" (the "auto" choice for a pinhole camera over
    triangles) casts bounce 0 through the screen-tile binning, its pair
    buffer sized by tri_max_pairs; "block" traces it through the
    traversal. Later bounces walk the table's per-ray tree, which plans
    no visits: "tri_visits_overflow" is then bounce 0's. `primary_ids`,
    where given, receives each sample's [H, W] int64 scene index of the
    triangle bounce 0 hits (-1 where it hits none); it takes no cutouts
    and no tri_clusters.

    Splats in the scene: `gaussians` (a GaussianCloud, traced brute force
    by `trace_gaussian_rays`, colours from SH seen from the camera),
    `gaussians` with `gauss_tree` (a prebuilt `ops.splat_bvh.SplatBVH`
    over them: each wave's segment is one per-ray tree walk,
    `trace_gaussian_rays_bvh`, with the same colours; retired and parked
    rays get empty windows) or `gauss_clusters` (prebuilt
    `ops.splat_clusters.SplatClusters`, traced by
    `trace_gaussian_rays_clustered` in blocks of gauss_rb rays, at most
    gauss_s_max super-clusters a block). Every bounce segment, up to its
    surface hit, composites through them (`_splat_segment`): their
    in-scatter is added and their transmittance scales the path's
    throughput, so splats are seen by primary, reflected and refracted
    rays alike. `primary_splat_hits`, where given, receives each sample's
    [H, W] count of the splats bounce 0's segment blended.

    Textured materials scale their albedo by the texture at the hit:
    trilinear at the ray-cone LOD of this segment (one pixel, 1/fy, wide)
    once `with_texture_mips` has run, else bilinear at level 0. Cutouts
    (`alpha_textures`) are skipped by `_closest_hit_cutout` on every
    traced bounce; they rule out the binned primary cast.

    Spans (`TRACER`): `pt.frame`, a root, round the call; `pt.colors`
    round the splats' SH colours (once a call, with `gaussians`);
    `pt.primary` round bounce 0's hit search (the binning and the binned
    cast, or the traversal); `pt.traverse` round each later bounce's;
    `pt.splats` round each wave's splat segment; `pt.sort` round a wave's
    coherence permutation, parking and un-permute; `pt.shade` round the
    rest of a bounce (the splat segment's composite, textures, the draws
    and the shading). Counters: `live_rays` and `rays`, the rays active
    on entering each wave and all of them; `shade_waves` and
    `shade_fused`, one a wave and one a wave the shading kernel shaded;
    `tri_visits` and `tri_blocks`, each block traversal's planned (block,
    super-cluster) visits and its blocks; `tri_nodes`, `tri_tests` and
    `tri_rays`, each per-ray walk's node records fetched, triangle tests
    and rays that entered the tree (on the card); on `pt.splats`,
    `splat_rays`, the live rays entering the segment, and with a tree on
    the card the kernel's `splat_nodes`, `splat_tests`, `splat_walks`,
    `splat_hits` and `splat_replays` (node records fetched, response
    evaluations, walks from the root, hits blended, passes replayed)."""
    with TRACER.span("pt.frame", root=True):
        return _path_trace(scene, camera, cfg, seed, aperture, focus,
                           gaussians, gauss_clusters, gauss_s_max, gauss_rb,
                           gauss_tree, primary_impl, tri_max_pairs,
                           tri_span_exact, sort_bounces, return_flags,
                           primary_ids, primary_splat_hits)


def _path_trace(scene, camera, cfg, seed, aperture, focus, gaussians,
                gauss_clusters, gauss_s_max, gauss_rb, gauss_tree,
                primary_impl, tri_max_pairs, tri_span_exact, sort_bounces,
                return_flags, primary_ids, primary_splat_hits):
    from gsrt_torch.models.gaussian_rt import unit_dirs
    from gsrt_torch.ops.sh import eval_sh

    H, W = camera.height, camera.width
    R = H * W
    dev = scene.device
    if gauss_tree is not None and (gaussians is None
                                   or gauss_clusters is not None):
        raise ValueError("gauss_tree traces the splats of `gaussians` (their "
                         "colours), without gauss_clusters")
    gen = torch.Generator(device=dev).manual_seed(seed)
    gauss_colors = None
    if gaussians is not None and gauss_clusters is None:
        with TRACER.span("pt.colors"):
            gauss_colors = eval_sh(gaussians.sh,
                                   unit_dirs(gaussians.means,
                                             camera.position),
                                   min(cfg.sh_degree, gaussians.sh_degree))
    has_gauss = gaussians is not None or gauss_clusters is not None
    segment = functools.partial(
        _splat_segment, cfg, gaussians=gaussians, colors=gauss_colors,
        gauss_clusters=gauss_clusters, gauss_tree=gauss_tree, rb=gauss_rb,
        s_max=gauss_s_max)
    primary_impl = _resolve_primary(primary_impl, scene, aperture)
    if primary_impl == "binned" and aperture != 0.0:
        raise ValueError("the binned primary cast needs a shared ray origin "
                         "(aperture 0)")
    if primary_impl == "binned" and scene.alpha_textures is not None:
        raise ValueError("the binned primary cast runs no cutouts")
    if primary_ids is not None and scene.alpha_textures is not None:
        raise ValueError("primary_ids takes no cutouts")
    textured = (scene.textures is not None
                and scene.materials.texture_id is not None)
    mip = (_mip_from_packed(scene.tex_mips) if textured
           and scene.tex_mips is not None and scene.mat_texel is not None
           else None)
    sort_lo, sort_hi, park_o, park_d = (
        _scene_sort_bounds(scene, gauss_clusters, gauss_tree)
        if sort_bounces else (None,) * 4)
    binning = None
    ovf_tri = torch.zeros((), dtype=torch.bool, device=dev)
    ovf_gauss = torch.zeros((), dtype=torch.bool, device=dev)
    acc = torch.zeros((R, 3), device=dev)

    def hits(o, d, b, tri_override=None):
        """A wave's (t, n, mat, hit, uv, ovf) and, on bounce 0 where
        primary_ids asks, the triangle index (else None)."""
        if b == 0 and primary_ids is not None:
            *out, tri = _closest_hit(scene, o, d, cfg.t_min, cfg.t_max,
                                     tri_override=tri_override, tri_id=True)
            return out, tri
        if tri_override is not None:
            return _closest_hit(scene, o, d, cfg.t_min, cfg.t_max,
                                tri_override=tri_override), None
        return _closest_hit_cutout(scene, o, d, cfg.t_min, cfg.t_max,
                                   per_ray=b > 0), None

    for _ in range(cfg.samples):
        orig, dirn = generate_camera_rays(gen, camera, cfg, aperture, focus)
        orig, dirn = orig.contiguous(), dirn.contiguous()   # shaded in place
        ray_color = torch.ones((R, 3), device=dev)
        out_color = torch.zeros((R, 3), device=dev)
        active = torch.ones((R,), dtype=torch.bool, device=dev)
        for b in range(cfg.bounces):
            if TRACER.recording():
                TRACER.count(live_rays=active.sum(), rays=R)
            search = "pt.primary" if b == 0 else "pt.traverse"
            g = None
            if b == 0 and primary_impl == "binned":
                with TRACER.span(search):
                    if binning is None:
                        binning = _tri_binning(scene, camera, cfg,
                                               tri_max_pairs, tri_span_exact)
                    (t, n, mat, hit, uv, ovf), tri = hits(
                        orig, dirn, b, _cast(binning, camera, cfg, dirn))
                if has_gauss:
                    g = segment(orig, dirn, t, hit, active)
            elif sort_lo is not None:
                with TRACER.span("pt.sort"):
                    perm, inv = _coherence_perm(orig, dirn, active, sort_lo,
                                                sort_hi)
                    act_s = active[perm][:, None]
                    o_s = torch.where(act_s, orig[perm], park_o)
                    d_s = torch.where(act_s, dirn[perm], park_d)
                with TRACER.span(search):
                    (t, n, mat, hit, uv, ovf), tri = hits(o_s, d_s, b)
                if has_gauss:
                    g = segment(o_s, d_s, t, hit, act_s[:, 0])
                with TRACER.span("pt.sort"):
                    if g is not None:
                        g = (g[0][inv], g[1][inv], g[2][inv], g[3])
                    t, n, mat, hit = t[inv], n[inv], mat[inv], hit[inv]
                    if uv is not None:
                        uv = uv[inv]
                    if tri is not None:
                        tri = tri[inv]
            else:
                with TRACER.span(search):
                    (t, n, mat, hit, uv, ovf), tri = hits(orig, dirn, b)
                if has_gauss:
                    g = segment(orig, dirn, t, hit, active)
            if tri is not None:
                primary_ids.append(tri.reshape(H, W))
            if b == 0 and g is not None and primary_splat_hits is not None:
                primary_splat_hits.append(g[2].reshape(H, W))
            ovf_tri = ovf_tri | ovf
            with TRACER.span("pt.shade"):
                if g is not None:
                    # the segment through the splats: their in-scatter,
                    # then T_gauss times what lies beyond
                    g_trans, g_color, _, g_ovf = g
                    ovf_gauss = ovf_gauss | g_ovf
                    act = active[:, None]
                    out_color = out_color + torch.where(
                        act, ray_color * g_color, 0.0)
                    ray_color = torch.where(
                        act, ray_color * g_trans[:, None], ray_color)
                tex_color = None
                if textured:
                    if uv is None:
                        uv = sphere_uv(n)
                    tid = scene.materials.texture_id[mat.long()]
                    if mip is not None:
                        from gsrt_torch.ops.mip import (ray_cone_lod,
                                                        sample_texture_lod)
                        lod = ray_cone_lod(t, 1.0 / camera.fy,
                                           scene.mat_texel[mat.long()])
                        tex_color = sample_texture_lod(mip, tid, uv, lod)
                    else:
                        tex_color = sample_texture(scene.textures, tid, uv)
                fused = _kernels.PT_SHADE.launches
                orig, dirn, ray_color, out_color, active = shade_wave(
                    gen, scene.materials, t, n, mat, hit, orig, dirn, active,
                    ray_color, out_color, tex_color, cfg.has_sky)
                TRACER.count(shade_waves=1,
                             shade_fused=_kernels.PT_SHADE.launches - fused)
        acc = acc + out_color
    color = acc / cfg.samples
    if cfg.gamma_correction:
        color = torch.sqrt(torch.clamp(color, 0.0, 1.0))
    img = color.reshape(H, W, 3)
    if return_flags:
        return img, {"tri_visits_overflow": ovf_tri,
                     "gauss_visits_overflow": ovf_gauss,
                     "binned_pairs_overflow": torch.zeros_like(ovf_tri)
                     if binning is None else binning.overflow}
    return img


def render_path_traced_calibrated(scene: PrimitiveScene, camera: Camera,
                                  cfg: RenderConfig, *,
                                  gauss_s_max: int = 48,
                                  tri_max_pairs: int = 1 << 20,
                                  max_retries: int = 2, growth: float = 2.0,
                                  **kw):
    """render_path_traced (`kw` its other arguments: `gaussians`,
    `gauss_tree`, `primary_ids`, ...) rendered again with a grown buffer
    while one overflows, at most max_retries times: tri_max_pairs (the
    binned pair buffer) times growth, and gauss_s_max (the clustered
    splats' visits; the splat tree has none) to max(gauss_s_max·growth,
    gauss_s_max + 8). Returns (img, info) with
    the final sizes, the retries and the last flags as Python values; it
    reads the flags from the device, in `pt.sync` spans under its own
    `pt.frame` root (each render's `pt.frame` nests in it)."""
    retries = 0
    with TRACER.span("pt.frame", root=True):
        while True:
            img, flags = render_path_traced(
                scene, camera, cfg, gauss_s_max=gauss_s_max,
                tri_max_pairs=tri_max_pairs, return_flags=True, **kw)
            with TRACER.span("pt.sync"):
                concrete = {k: bool(v) for k, v in flags.items()}
            grow_pairs = concrete["binned_pairs_overflow"]
            grow_smax = concrete["gauss_visits_overflow"]
            if not (grow_pairs or grow_smax) or retries >= max_retries:
                return img, {"retries": retries, "gauss_s_max": gauss_s_max,
                             "tri_max_pairs": tri_max_pairs,
                             "flags": concrete}
            if grow_pairs:
                tri_max_pairs = int(tri_max_pairs * growth)
            if grow_smax:
                gauss_s_max = max(int(gauss_s_max * growth), gauss_s_max + 8)
            retries += 1


def render_foveated(scene: PrimitiveScene, camera: Camera,
                    cfg: RenderConfig, seed: int = 0, rings=(15, 40),
                    ring_samples=(16, 8, 1), aperture: float = 0.0,
                    focus: float = 1.0, **pt_kwargs):
    """PT with a sample count per pixel by its distance r from the image
    centre: ring_samples[0] within rings[0] px, [1] within rings[1] px,
    [2] beyond. Renders max(ring_samples) one-sample images at seeds
    seed·max_spp + s and averages each pixel's first spp of them; gamma,
    where configured, applies after the average."""
    H, W = camera.height, camera.width
    dev = scene.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    r = torch.sqrt((xs - W / 2.0) ** 2 + (ys - H / 2.0) ** 2).to(torch.int32)
    spp = torch.where(r > rings[1], ring_samples[2], torch.where(
        r > rings[0], ring_samples[1], ring_samples[0])).reshape(-1)
    max_spp = max(ring_samples)
    acc = torch.zeros((H * W, 3), device=dev)
    cfg1 = cfg.replace(samples=1, gamma_correction=False)
    for s in range(max_spp):
        img = render_path_traced(scene, camera, cfg1, seed=seed * max_spp + s,
                                 aperture=aperture, focus=focus, **pt_kwargs)
        acc = acc + torch.where((s < spp)[:, None], img.reshape(-1, 3), 0.0)
    out = (acc / spp[:, None]).reshape(H, W, 3)
    if cfg.gamma_correction:
        out = torch.sqrt(torch.clamp(out, 0.0, 1.0))
    return out


def _primary(scene, camera, cfg, gen, primary_impl, tri_max_pairs,
             tri_span_exact):
    """The SH/AO primary segment: camera rays, their hits and the
    offset hit points; returns (dirn, n, mat, hit, hit_p, ovf, pairs_ovf)."""
    orig, dirn = generate_camera_rays(gen, camera, cfg)
    tri_ov = None
    pairs_ovf = torch.zeros((), dtype=torch.bool, device=orig.device)
    if _resolve_primary(primary_impl, scene) == "binned":
        binning = _tri_binning(scene, camera, cfg, tri_max_pairs,
                               tri_span_exact)
        tri_ov, pairs_ovf = _cast(binning, camera, cfg, dirn), \
            binning.overflow
    t, n, mat, hit, _, ovf = _closest_hit(scene, orig, dirn, cfg.t_min,
                                          cfg.t_max, tri_override=tri_ov)
    hit_p = orig + t[:, None] * dirn + 1e-3 * n
    return dirn, n, mat, hit, hit_p, ovf, pairs_ovf


def render_shadow_rays(scene: PrimitiveScene, camera: Camera,
                       cfg: RenderConfig, light_pos, light_radius=0.5,
                       seed: int = 0, primary_impl: str = "auto",
                       tri_max_pairs: int = 1 << 20,
                       tri_span_exact: bool = False,
                       return_flags: bool = False):
    """Primary hit, then cfg.shadow_rays rays toward points on the light
    sphere; shade = albedo · (0.1 + 0.9 · visibility · n·l). As in the
    JAX package, targets sample the whole light sphere and the emitter's
    own geometry is not excluded."""
    H, W = camera.height, camera.width
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    dirn, n, mat, hit, hit_p, ovf, pairs_ovf = _primary(
        scene, camera, cfg, gen, primary_impl, tri_max_pairs, tri_span_exact)
    light = torch.as_tensor(light_pos, dtype=torch.float32,
                            device=hit_p.device)
    vis = torch.zeros((hit_p.shape[0],), device=hit_p.device)
    for _ in range(cfg.shadow_rays):
        target = light + light_radius * _random_unit(gen,
                                                     (hit_p.shape[0], 3))
        ld = target - hit_p
        dist = torch.linalg.norm(ld, dim=-1, keepdim=True)
        ld = ld / torch.clamp_min(dist, 1e-9)
        below = (ld * n).sum(-1) <= 0
        occ, ovf_s = _any_hit(scene, hit_p, ld, cfg.t_min, dist - 1e-2,
                              live=hit & ~below, sort=False)
        ovf = ovf | ovf_s
        vis = vis + torch.where(below | occ, 0.0, 1.0)
    vis = vis / max(cfg.shadow_rays, 1)
    ndl = torch.clamp_min((n * (light - hit_p)).sum(-1), 0.0)
    ndl = ndl / torch.clamp_min(torch.linalg.norm(light - hit_p, dim=-1),
                                1e-9)
    albedo = scene.materials.diffuse[mat.long()]
    color = torch.where(hit[:, None],
                        albedo * (0.1 + 0.9 * vis * ndl)[:, None],
                        _sky(dirn, cfg.has_sky))
    img = color.reshape(H, W, 3)
    if return_flags:
        return img, {"tri_visits_overflow": ovf,
                     "binned_pairs_overflow": pairs_ovf}
    return img


def render_ambient_occlusion(scene: PrimitiveScene, camera: Camera,
                             cfg: RenderConfig, seed: int = 0,
                             ao_radius: float = 2.0,
                             primary_impl: str = "auto",
                             tri_max_pairs: int = 1 << 20,
                             tri_span_exact: bool = False,
                             return_flags: bool = False):
    """Primary hit + cfg.ao_rays occlusion rays, uniform over the normal's
    hemisphere (a flipped unit-sphere sample), up to ao_radius."""
    H, W = camera.height, camera.width
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    dirn, n, mat, hit, hit_p, ovf, pairs_ovf = _primary(
        scene, camera, cfg, gen, primary_impl, tri_max_pairs, tri_span_exact)
    occ = torch.zeros((hit_p.shape[0],), device=hit_p.device)
    for _ in range(cfg.ao_rays):
        d = _random_unit(gen, (hit_p.shape[0], 3))
        d = torch.where((d * n).sum(-1, keepdim=True) < 0, -d, d)
        blocked, ovf_s = _any_hit(scene, hit_p, d, cfg.t_min, ao_radius,
                                  live=hit)
        occ = occ + torch.where(blocked, 1.0, 0.0)
        ovf = ovf | ovf_s
    ao = 1.0 - occ / max(cfg.ao_rays, 1)
    color = torch.where(hit[:, None], ao[:, None].expand(-1, 3),
                        _sky(dirn, cfg.has_sky))
    img = color.reshape(H, W, 3)
    if return_flags:
        return img, {"tri_visits_overflow": ovf,
                     "binned_pairs_overflow": pairs_ovf}
    return img
