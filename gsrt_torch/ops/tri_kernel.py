"""Cluster-BVH closest hit and any hit for triangle meshes (counterpart of
`gsrt.ops.tri_kernel`).

1. Build (`build_tri_table`, once per scene): triangles are Morton
   clustered (`ops.clusters.build_clusters`, K = 128 per cluster, SUP = 8
   clusters per super-cluster); the table holds each cluster's 9 geometry
   rows (v0, e1 = v1 − v0, e2 = v2 − v0) over its K triangles, and each
   cluster's AABB. Padding slots repeat the last triangle. `order`,
   `sup_min` and `sup_max` equal the JAX package's; the layout is the
   port's own ([M, 9, K] rows, not the TPU's sublane/lane tiles).
2. Plan (`plan_visits`, PyTorch, as it is XLA in the JAX package): rays go
   in blocks of `rb` consecutive rays; an interval slab test and a
   bounding-cone test of each block against every super-cluster AABB give
   a candidate list per block, sorted front to back by the block's
   conservative entry distance.
3. Traverse (`closest_hit_packed`): on a CUDA tensor the kernel
   `csrc/tri_kernel.cu` (which replaces the TPU kernel `_tri_kernel`), on a
   CPU tensor `closest_hit_packed_plain`. Per block it walks the visit list;
   visit j + 1 runs only if its entry distance is below the block's largest
   best t taken before visit j (clamped at 0; in any-hit mode a ray that
   has a hit counts as −inf), so the executed-visit count `plan.actual`
   follows the TPU kernel's. Each cluster is culled for each group of
   `CULL_RAYS` consecutive rays (one warp of the kernel) by a slab test of
   its AABB against each ray's window [tmin, min(tmax, best)] (any hit:
   empty once the ray has a hit); where some ray of the group reaches it,
   every ray of the group tests it densely with Möller–Trumbore. A ray
   keeps the smallest t, ties to the smallest triangle slot, and takes a
   later cluster's only when strictly nearer. The TPU kernel culls for the
   whole block (`cull_rays=rb` in the plain version); the two differ only
   where rounding lets a ray hit a triangle of a cluster that its own
   window misses.

The returned index is a slot; `order[slot]` is the triangle id.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsrt_torch import _kernels

K = 128            # triangles per cluster
SUP = 8            # clusters per super-cluster
GEOM = 9           # geometry rows per cluster: v0 xyz, e1 xyz, e2 xyz
RAY_ROWS = 8       # ox oy oz dx dy dz tmin tmax
INF_BITS = 0x7F800000
PLAIN_PAIRS = 1 << 24   # ray-triangle products per batch of the plain version
CULL_RAYS = 32          # rays culled together: one warp of the kernel


class TriTable(NamedTuple):
    """Packed triangle clusters and their bounds."""
    table: torch.Tensor     # [M, 9, K] f32 geometry rows, M = MS·SUP
    cl_min: torch.Tensor    # [M, 3] cluster AABBs
    cl_max: torch.Tensor    # [M, 3]
    sup_min: torch.Tensor   # [MS, 3] super-cluster AABBs
    sup_max: torch.Tensor   # [MS, 3]
    order: torch.Tensor     # [M·K] int32 slot → triangle id
    n_tris: int
    bvh: object | None = None   # ops.tri_bvh.TriBVH over the slots


def build_tri_table(v0, v1, v2) -> TriTable:
    """Morton-cluster a [N, 3] triangle soup into the traversal table."""
    from gsrt_torch.ops.clusters import build_clusters

    bmin = torch.minimum(torch.minimum(v0, v1), v2)
    bmax = torch.maximum(torch.maximum(v0, v1), v2)
    clusters, order = build_clusters(bmin, bmax, k=K, sup=SUP)
    m = clusters.m
    idx = order.long()
    tv0 = v0[idx]
    rows = torch.cat([tv0, v1[idx] - tv0, v2[idx] - tv0], 1)  # [M·K, 9]
    table = rows.reshape(m, K, GEOM).transpose(1, 2).contiguous()
    return TriTable(table=table, cl_min=clusters.cl_min,
                    cl_max=clusters.cl_max, sup_min=clusters.sup_min,
                    sup_max=clusters.sup_max, order=order,
                    n_tris=v0.shape[0])


class VisitPlan(NamedTuple):
    block_start: torch.Tensor  # [B + 1] int32 visit offsets per ray block
    visit: torch.Tensor        # [MV] int32 super-cluster ids, block-major,
                               #      front to back within each block
    visit_near: torch.Tensor   # [MV] int32 entry distance of each visit,
                               #      the bits of a non-negative f32
    total: torch.Tensor        # [] int32 visits before capping
    overflow: torch.Tensor     # [] bool
    actual: torch.Tensor | None = None
                               # [B] int32 visits each block executed
                               #      (closest_hit_packed fills it)


def _norm(a, dim=-1, keepdim=False):
    return torch.sqrt((a * a).sum(dim, keepdim=keepdim))


def plan_visits(orig, dirn, t_min, t_max, sup_min, sup_max,
                rb: int, max_visits: int) -> VisitPlan:
    """Conservative (block × super-cluster) candidate list. orig/dirn
    [R, 3] with R % rb == 0; t_min/t_max [R]."""
    R = orig.shape[0]
    if R % rb:
        raise ValueError(f"{R} rays are not a multiple of rb={rb}")
    B = R // rb
    ms = sup_min.shape[0]
    dev = orig.device
    inf = float("inf")

    ob = orig.reshape(B, rb, 3)
    db = dirn.reshape(B, rb, 3)
    olo, ohi = ob.amin(1)[:, None, :], ob.amax(1)[:, None, :]
    dlo, dhi = db.amin(1)[:, None, :], db.amax(1)[:, None, :]
    ok_axis = (dlo > 0) | (dhi < 0)
    one = torch.ones_like(dlo)
    ilo = 1.0 / torch.where(ok_axis, dhi, one)
    ihi = 1.0 / torch.where(ok_axis, dlo, one)
    nlo = sup_min[None] - ohi                           # (B, MS, 3)
    nhi = sup_max[None] - olo
    p1, p2, p3, p4 = nlo * ilo, nlo * ihi, nhi * ilo, nhi * ihi
    plo = torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4))
    phi = torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4))
    plo = torch.where(ok_axis, plo, torch.full_like(plo, -inf))
    phi = torch.where(ok_axis, phi, torch.full_like(phi, inf))
    near_lb = plo.amax(-1)                              # (B, MS)
    far_ub = phi.amin(-1)
    tmin_blk = t_min.reshape(B, rb).amin(1)[:, None]
    tmax_blk = t_max.reshape(B, rb).amax(1)[:, None]
    mask = (near_lb <= far_ub) & (far_ub >= tmin_blk) & (near_lb <= tmax_blk)

    # bounding cone of the block against each super-cluster's sphere
    dmag = _norm(db, keepdim=True)                      # (B, rb, 1)
    dn = db / torch.clamp_min(dmag, 1e-12)
    dist_blk = tmax_blk * dmag[:, :, 0].amax(1)[:, None]
    axis = dn.mean(1)
    axis = axis / torch.clamp_min(_norm(axis, keepdim=True), 1e-9)
    cos_raw = (dn * axis[:, None, :]).sum(-1).amin(1)   # (B,)
    cos_t = torch.clamp(cos_raw, 0.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    o_c = 0.5 * (olo + ohi)[:, 0, :]
    o_r = 0.5 * _norm((ohi - olo)[:, 0, :])
    c_c = 0.5 * (sup_min + sup_max)
    c_r = 0.5 * _norm(sup_max - sup_min)
    v = c_c[None] - o_c[:, None, :]
    dz = (v * axis[:, None, :]).sum(-1)
    reach = torch.minimum(torch.clamp_min(dz + c_r[None, :], 0.0), dist_blk)
    tan_t = sin_t / torch.clamp_min(cos_t, 1e-3)
    w = (o_r[:, None] + tan_t[:, None] * reach)[..., None]
    amin = sup_min[None] - w - o_c[:, None, :]
    amax = sup_max[None] + w - o_c[:, None, :]
    usable = axis.abs() > 1e-6
    inv_ax = 1.0 / torch.where(usable, axis, torch.ones_like(axis))
    lo = amin * inv_ax[:, None, :]
    hi = amax * inv_ax[:, None, :]
    t_lo, t_hi = torch.minimum(lo, hi), torch.maximum(lo, hi)
    u3 = usable[:, None, :]
    near = torch.where(u3, t_lo, torch.full_like(t_lo, -inf)).amax(-1)
    far = torch.where(u3, t_hi, torch.full_like(t_hi, inf)).amin(-1)
    contained = (u3 | ((amin <= 0.0) & (amax >= 0.0))).all(-1)
    cone_ok = ((near <= far) & (far >= -o_r[:, None]) & (near <= dist_blk)
               & contained)
    cone_ok = cone_ok | (cos_raw <= 0.0)[:, None]
    mask &= cone_ok

    counts = mask.sum(1, dtype=torch.int32)
    total = counts.sum(dtype=torch.int32)
    block_start = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             torch.cumsum(counts, 0, dtype=torch.int32)])
    block_start = torch.clamp_max(block_start, max_visits)

    # block-major, front to back: one stable sort on (block, near bits)
    flat = mask.reshape(B * ms)
    near_f = torch.clamp(torch.maximum(near_lb, tmin_blk), 0.0, 3.0e38)
    near_i = near_f.contiguous().view(torch.int32).reshape(B * ms)
    blk = torch.arange(B * ms, device=dev) // ms
    blk_key = torch.where(flat, blk, torch.full_like(blk, B))
    near_key = torch.where(flat, near_i, torch.full_like(near_i, INF_BITS))
    perm = torch.sort((blk_key << 32) | near_key.to(torch.int64),
                      stable=True).indices
    near_s = near_key[perm]
    sup_s = (perm % ms).to(torch.int32)
    if B * ms >= max_visits:
        near_s, sup_s = near_s[:max_visits], sup_s[:max_visits]
    else:
        pad = max_visits - B * ms
        near_s = torch.cat([near_s, near_s.new_full((pad,), INF_BITS)])
        sup_s = torch.cat([sup_s, sup_s.new_zeros(pad)])
    return VisitPlan(block_start=block_start, visit=sup_s.contiguous(),
                     visit_near=near_s.contiguous(), total=total,
                     overflow=total > max_visits)


def _prepare(tt: TriTable, orig, dirn, t_min, t_max, rb: int,
             max_visits: int | None):
    """Pad the rays to whole blocks (repeating the last ray, tmin 1e30 and
    tmax 0 so padding never hits), stack the [8, Rp] ray rows, plan."""
    if rb % 32 or not 0 < rb <= 1024:
        raise ValueError("rb must be a multiple of 32 and at most 1024")
    R = orig.shape[0]
    pad = (-R) % rb
    f32 = dict(dtype=torch.float32, device=orig.device)

    def row(x):
        x = torch.as_tensor(x, **f32)
        return x.reshape(-1).expand(R) if x.dim() else x.expand(R)
    tmin_a, tmax_a = row(t_min), row(t_max)
    if pad:
        orig = torch.cat([orig, orig[-1:].expand(pad, 3)])
        dirn = torch.cat([dirn, dirn[-1:].expand(pad, 3)])
        tmin_a = torch.cat([tmin_a, torch.full((pad,), 1e30, **f32)])
        tmax_a = torch.cat([tmax_a, torch.zeros(pad, **f32)])
    B = (R + pad) // rb
    if max_visits is None:
        max_visits = min(B * tt.sup_min.shape[0], 1 << 22)
    plan = plan_visits(orig, dirn, tmin_a, tmax_a, tt.sup_min, tt.sup_max,
                       rb, max_visits)
    rays = torch.stack([orig[:, 0], orig[:, 1], orig[:, 2], dirn[:, 0],
                        dirn[:, 1], dirn[:, 2], tmin_a, tmax_a]).contiguous()
    return rays, plan, R


def _finish(t, slot, actual, plan, R):
    t, slot = t[:R], slot[:R]
    return t, slot, torch.isfinite(t), plan._replace(actual=actual)


def closest_hit_packed(tt: TriTable, orig, dirn, t_min, t_max, *,
                       rb: int = 512, max_visits: int | None = None,
                       any_hit: bool = False):
    """Bundle closest hit through the table. orig/dirn [R, 3]; t_min/t_max
    scalars, [R] or [R, 1]. Returns (t [R] (+inf on a miss), slot [R] into
    tt.order, hit [R], plan with `actual`). any_hit relaxes the search to
    occlusion: t is a valid hit in (t_min, t_max), not necessarily the
    nearest, and a block stops once every ray has one. CUDA tensors launch
    `csrc/tri_kernel.cu`; CPU tensors run the plain version."""
    rays, plan, R = _prepare(tt, orig, dirn, t_min, t_max, rb, max_visits)
    if not rays.is_cuda:
        return _finish(*_traverse_plain(tt, rays, plan, rb, any_hit), plan,
                       R)
    return _finish(*traverse(tt, rays, plan, rb, any_hit), plan, R)


def traverse(tt: TriTable, rays, plan: VisitPlan, rb: int, any_hit: bool):
    """One launch of the traversal kernel on prepared [8, Rp] CUDA ray
    rows and their plan: (t [Rp], slot [Rp], actual [B])."""
    if not (rays.is_cuda and tt.table.device == rays.device ==
            plan.visit.device):
        raise ValueError("traverse takes the rays, table and plan on one "
                         "CUDA device")
    Rp = rays.shape[1]
    B = Rp // rb
    t = torch.empty(Rp, dtype=torch.float32, device=rays.device)
    slot = torch.empty(Rp, dtype=torch.int32, device=rays.device)
    actual = torch.empty(B, dtype=torch.int32, device=rays.device)
    table = tt.table.contiguous()
    box = torch.cat([tt.cl_min, tt.cl_max], 1).contiguous()
    sup_box = torch.cat([tt.sup_min, tt.sup_max], 1).contiguous()
    kernel = _kernels.TRI_ANY_HIT if any_hit else _kernels.TRI_CLOSEST_HIT
    with torch.cuda.device(rays.device):
        kernel(table.data_ptr(), box.data_ptr(), sup_box.data_ptr(),
               table.shape[0],
               plan.block_start.data_ptr(), plan.visit.data_ptr(),
               plan.visit_near.data_ptr(), plan.visit.shape[0],
               rays.data_ptr(), Rp, rb, CULL_RAYS, int(any_hit),
               t.data_ptr(), slot.data_ptr(), actual.data_ptr(),
               _kernels.stream_ptr(rays))
    return t, slot, actual


def closest_hit_packed_plain(tt: TriTable, orig, dirn, t_min, t_max, *,
                             rb: int = 512, max_visits: int | None = None,
                             any_hit: bool = False, stats: dict | None = None,
                             cull_rays: int = CULL_RAYS):
    """The plain PyTorch version of `closest_hit_packed` on any device.
    `cull_rays` rays are culled together (the kernel's CULL_RAYS; `rb`
    gives the TPU kernel's block cull). `stats` receives the executed
    block-visits ("visits"), the (block, cluster) pairs where some group
    passed the cull ("clusters_tested"), the (group, cluster) pairs that
    passed it ("group_clusters_tested") and those that passed it with the
    best before their visit ("group_candidates": the pairs the kernel
    tests, a superset)."""
    rays, plan, R = _prepare(tt, orig, dirn, t_min, t_max, rb, max_visits)
    return _finish(*_traverse_plain(tt, rays, plan, rb, any_hit, stats,
                                    cull_rays), plan, R)


def _mt(ox, oy, oz, dx, dy, dz, tmin, tmax, g):
    """Möller–Trumbore of rays (fields broadcast as [..., 1, 1]) against
    geometry rows g[..., r, K], rounded as the kernel rounds it: each
    product and sum on its own, left to right. Returns t (+inf on a miss)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (g[..., r, :]
                                                  for r in range(GEOM))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) \
        & (t < tmax)
    return torch.where(ok, t, torch.full_like(t, float("inf")))


def _traverse_plain(tt: TriTable, rays, plan: VisitPlan, rb: int,
                    any_hit: bool, stats: dict | None = None,
                    cull_rays: int = CULL_RAYS):
    """The kernel's walk in tensor code: every block that goes on takes
    its next visit in one step. Möller–Trumbore runs, PLAIN_PAIRS products
    at a time, only on the (group, cluster) pairs that pass the cull with
    the best before the visit; the cull with the running best, cluster by
    cluster, then selects among them, as it can only narrow."""
    if rb % cull_rays:
        raise ValueError(f"cull_rays={cull_rays} does not divide rb={rb}")
    dev = rays.device
    B = rays.shape[1] // rb
    G, ng = cull_rays, rb // cull_rays
    inf = float("inf")
    f = rays.reshape(RAY_ROWS, B, rb)
    ox, oy, oz, dx, dy, dz, tmin, tmax = f
    eps = 1e-20
    ivx, ivy, ivz = (1.0 / torch.where(d.abs() < eps, torch.full_like(d, eps),
                                       d) for d in (dx, dy, dz))
    bt = torch.full((B, rb), inf, device=dev)
    bi = torch.zeros((B, rb), dtype=torch.int32, device=dev)
    actual = torch.zeros(B, dtype=torch.int32, device=dev)
    bs = plan.block_start.long()
    nv = bs[1:] - bs[:-1]
    mv = plan.visit_near.shape[0]
    geo = tt.table.reshape(-1, SUP, GEOM, K)
    box = torch.cat([tt.cl_min, tt.cl_max], 1).reshape(-1, SUP, 6)
    go = nv > 0
    n_visits = 0
    n_block = torch.zeros((), dtype=torch.int64, device=dev)
    n_group = torch.zeros((), dtype=torch.int64, device=dev)
    n_cand = torch.zeros((), dtype=torch.int64, device=dev)
    batch = max(1, PLAIN_PAIRS // (rb * K))
    gbatch = max(1, PLAIN_PAIRS // (G * K))
    j = 0
    while bool(go.any()):
        act = go.nonzero()[:, 0]
        # continue to visit j + 1? decided from the best before visit j
        b_eff = bt[act]
        if any_hit:
            b_eff = torch.where(torch.isfinite(b_eff),
                                torch.full_like(b_eff, -inf), b_eff)
        best_max = torch.clamp_min(b_eff.amax(1), 0.0).view(torch.int32)
        nxt = plan.visit_near[torch.clamp_max(bs[act] + j + 1, mv - 1)]
        go_next = (j + 1 < nv[act]) & (nxt < best_max)
        for s in range(0, act.numel(), batch):
            blk = act[s:s + batch]
            nb = blk.numel()
            c = plan.visit[bs[blk] + j].long()
            btb, bib = bt[blk], bi[blk]

            def cull(cj, best):
                """Does some ray of each group reach cluster cj's AABB
                inside its window, given its best t? [b, ng]"""
                bx = box[c, cj]                                # [b, 6]
                lim = (torch.where(torch.isfinite(best),
                                   torch.full_like(best, -inf), tmax[blk])
                       if any_hit else torch.minimum(tmax[blk], best))
                sl = [(bx[:, a, None] - o[blk]) * iv[blk] for a, o, iv in
                      ((0, ox, ivx), (3, ox, ivx), (1, oy, ivy),
                       (4, oy, ivy), (2, oz, ivz), (5, oz, ivz))]
                l0, h0, l1, h1, l2, h2 = sl
                t_in = torch.maximum(
                    torch.maximum(torch.minimum(l0, h0),
                                  torch.minimum(l1, h1)),
                    torch.maximum(torch.minimum(l2, h2), tmin[blk]))
                t_out = torch.minimum(
                    torch.minimum(torch.maximum(l0, h0),
                                  torch.maximum(l1, h1)),
                    torch.minimum(torch.maximum(l2, h2), lim))
                return (t_in <= t_out).reshape(nb, ng, G).any(2)

            # each ray's first minimum over each candidate cluster
            cand = torch.stack([cull(cj, btb) for cj in range(SUP)], 1)
            n_cand += cand.sum()
            tc = torch.full((nb, SUP, ng, G), inf, device=dev)
            ic = torch.zeros((nb, SUP, ng, G), dtype=torch.int64, device=dev)
            pb, pc, pg = cand.nonzero(as_tuple=True)
            for q in range(0, pb.numel(), gbatch):
                qb, qc, qg = (a[q:q + gbatch] for a in (pb, pc, pg))
                r = lambda a: a[blk[qb]].reshape(-1, ng, G)[       # noqa
                    torch.arange(qb.numel(), device=dev), qg][:, :, None]
                t = _mt(r(ox), r(oy), r(oz), r(dx), r(dy), r(dz), r(tmin),
                        r(tmax), geo[c[qb], qc][:, None])      # [n, G, K]
                tc[qb, qc, qg], ic[qb, qc, qg] = t.min(-1)
            tc, ic = tc.reshape(nb, SUP, rb), ic.reshape(nb, SUP, rb)
            for cj in range(SUP):
                run = cull(cj, btb)
                n_block += run.any(1).sum()
                n_group += run.sum()
                upd = run.repeat_interleave(G, 1) & (tc[:, cj] < btb)
                btb = torch.where(upd, tc[:, cj], btb)
                slot = ((c * SUP + cj) * K)[:, None] + ic[:, cj]
                bib = torch.where(upd, slot.to(torch.int32), bib)
            bt[blk], bi[blk] = btb, bib
        actual[act] += 1
        n_visits += act.numel()
        go = torch.zeros_like(go)
        go[act] = go_next
        j += 1
    if stats is not None:
        stats.update(visits=n_visits, clusters_tested=int(n_block),
                     group_clusters_tested=int(n_group),
                     group_candidates=int(n_cand))
    return bt.reshape(-1), bi.reshape(-1), actual
