"""Cluster-filtered tracing of arbitrary rays through a Gaussian cloud
(counterpart of `gsrt.ops.splat_clusters`).

`trace_gaussian_rays` (models.gaussian_rt) tests every splat against
every ray each pass. Here the splats are Morton-packed into clusters of K
with conservative world boxes (mean ± sqrt(2·G_eff·λ_max(Σ)), λ_max
bounded by Gershgorin rows: past that radius alpha is under the
threshold in every direction), and `sup` consecutive clusters share a
super-cluster box. Each k-buffer pass then

  1. plans: every ray slab-tests every super-cluster box over its live
     window [front, t_max]; rays form blocks of `rb` consecutive rays, and
     a block visits a super-cluster when any of its rays enters it, the
     first `s_max` in Morton order (`plan_visits`; more sets the overflow
     flag, and the rest are dropped);
  2. traces: s_max·sup cluster steps; at step j each block takes the
     j % sup-th cluster of its (j // sup)-th visited super-cluster, whose
     K members are merged into its rays' k-buffers (the brute-force pass's
     body over visited clusters only).

The plan is redone every pass, since the windows shrink as the fronts
advance. Equal t* are taken lowest position first over [buffer, cluster
members], as in the JAX package's `lax.top_k`: across clusters that is
the clustered (Morton) slot order, where the brute-force tracer takes the
lowest splat index, so the two may break a tie differently.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import GaussianCloud
from gsrt_torch.ops.clusters import (Clusters, build_clusters, ray_aabb_hit,
                                     safe_inv_dir)
from gsrt_torch.ops.gaussian import invert_cov3d, ray_gaussian_response
from gsrt_torch.ops.kbuffer import finish_pass, merge_nearest, ray_window


class SplatClusters(NamedTuple):
    """Morton-clustered splats, [M, K, ...]; padding slots have opacity 0."""
    clusters: Clusters
    means: torch.Tensor     # [M, K, 3]
    cov_inv: torch.Tensor   # [M, K, 6] upper-triangular Σ⁻¹
    opacity: torch.Tensor   # [M, K] (0 on padding and under the threshold)
    colors: torch.Tensor    # [M, K, 3]

    @property
    def m(self) -> int:
        return self.means.shape[0]

    @property
    def k(self) -> int:
        return self.means.shape[1]


def splat_world_radius(cloud: GaussianCloud, cfg: RenderConfig
                       ) -> torch.Tensor:
    """Conservative world-space radius per splat past which alpha is under
    the threshold in every direction: sqrt(2·G_eff·λ_max), λ_max bounded by
    the largest Gershgorin row sum of Σ."""
    c = cloud.cov3d
    row0 = c[:, 0].abs() + c[:, 1].abs() + c[:, 2].abs()
    row1 = c[:, 1].abs() + c[:, 3].abs() + c[:, 4].abs()
    row2 = c[:, 2].abs() + c[:, 4].abs() + c[:, 5].abs()
    lam = torch.maximum(row0, torch.maximum(row1, row2))
    g_eff = torch.clamp_max(torch.clamp_min(torch.log(torch.clamp_min(
        cloud.opacity / cfg.alpha_threshold, 1e-6)), 0.0), cfg.g_cutoff)
    return torch.sqrt(2.0 * g_eff * lam)


def build_splat_clusters(cloud: GaussianCloud, cfg: RenderConfig, colors,
                         k: int = 128, sup: int = 8) -> SplatClusters:
    """Cluster a cloud for arbitrary-ray tracing, once per scene. `colors`
    [N, 3] per splat (e.g. SH seen from one point)."""
    r = splat_world_radius(cloud, cfg)[:, None]
    clusters, order = build_clusters(cloud.means - r, cloud.means + r,
                                     k=k, sup=sup)
    m = clusters.m
    idx = order.long()
    op = torch.where(cloud.opacity > cfg.alpha_threshold, cloud.opacity,
                     torch.zeros_like(cloud.opacity))
    return SplatClusters(
        clusters=clusters,
        means=cloud.means[idx].reshape(m, k, 3),
        cov_inv=invert_cov3d(cloud.cov3d)[idx].reshape(m, k, 6),
        opacity=torch.where(clusters.valid, op[idx].reshape(m, k),
                            torch.zeros((m, k), device=op.device)),
        colors=colors[idx].reshape(m, k, 3))


def plan_visits(sc: SplatClusters, orig, dirn, t_lo, t_hi, rb: int,
                s_max: int):
    """Each block's visited super-clusters. orig, dirn [R, 3] with
    R % rb == 0; t_lo, t_hi [R] the live windows. Returns (sup_ids
    [B, s_max] int32, ascending, the sentinel MS where unused; n_hit [B]
    int32; overflow [] bool: some block enters more than s_max)."""
    cl = sc.clusters
    ms = cl.sup_min.shape[0]
    B = orig.shape[0] // rb
    hit = ray_aabb_hit(orig[:, None, :], safe_inv_dir(dirn)[:, None, :],
                       cl.sup_min[None], cl.sup_max[None],
                       t_lo[:, None], t_hi[:, None])            # [R, MS]
    block_hit = hit.reshape(B, rb, ms).any(1)                   # [B, MS]
    n_hit = block_hit.sum(1, dtype=torch.int32)
    overflow = (n_hit > s_max).any()
    # hit super-clusters first, in ascending Morton order
    sid = torch.arange(ms, dtype=torch.int32, device=orig.device)
    score = torch.where(block_hit, ms - sid, torch.full_like(sid, -1))
    val, idx = torch.topk(score, min(s_max, ms), dim=1)
    sup_ids = torch.where(val > 0, idx.to(torch.int32),
                          torch.full_like(val, ms))
    if s_max > ms:
        sup_ids = torch.cat([sup_ids, torch.full(
            (B, s_max - ms), ms, dtype=torch.int32, device=orig.device)], 1)
    return sup_ids, n_hit, overflow


def trace_gaussian_rays_clustered(sc: SplatClusters, origins, dirs,
                                  cfg: RenderConfig, t_max=None,
                                  rb: int = 256, s_max: int = 32):
    """`trace_gaussian_rays` through visited clusters only: the same
    returns plus the plan's overflow flag, (trans [R], color [R, 3], hits
    [R], overflow [] bool), the flag the OR over passes. The rays are
    padded to a multiple of rb with rays whose window is empty
    (t_max = −inf). Overflow means some block entered more than s_max
    super-clusters in some pass and lost the last ones: trace again with
    a larger s_max.

    Every ray is planned every pass (the flag counts rays that are done,
    as in the JAX package), but a step traces only the blocks that visit
    a cluster there and still hold a live ray: the steps and blocks left
    out would merge nothing into a live ray's buffer, so the outputs are
    those of all s_max·sup steps over every block."""
    dev = origins.device
    R0 = origins.shape[0]
    pad = (-R0) % rb
    tmax_r = ray_window(t_max, R0, cfg, dev)
    if pad:
        ones = torch.ones((pad, 3), dtype=origins.dtype, device=dev)
        origins, dirs = torch.cat([origins, ones]), torch.cat([dirs, ones])
        tmax_r = torch.cat([tmax_r, torch.full((pad,), float("-inf"),
                                               device=dev)])
    R = origins.shape[0]
    B = R // rb
    k, K, sup = cfg.k, sc.k, sc.clusters.sup
    ms = sc.clusters.sup_min.shape[0]
    init_d = float(cfg.init_depth)
    ob, db = origins.reshape(B, rb, 3), dirs.reshape(B, rb, 3)
    hi_b = tmax_r.reshape(B, rb, 1)
    colors = sc.colors.reshape(-1, 3)
    member = torch.arange(K, device=dev)

    front = torch.zeros(R, device=dev)
    trans = torch.ones(R, device=dev)
    color = torch.zeros((R, 3), device=dev)
    hits = torch.zeros(R, dtype=torch.int32, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    while not bool(done.all()):
        t_lo = torch.clamp_min(front, cfg.t_min)
        sup_ids, _, ovf = plan_visits(sc, origins, dirs, t_lo, tmax_r, rb,
                                      s_max)
        overflow = overflow | ovf
        lo_b = t_lo.reshape(B, rb, 1)
        kd = torch.full((B, rb, k), init_d, device=dev)
        ka = torch.zeros((B, rb, k), device=dev)
        ki = torch.zeros((B, rb, k), dtype=torch.int64, device=dev)
        # the (block, step) pairs that can change a live ray's buffer
        visit = (sup_ids < ms) & (~done).reshape(B, rb).any(1)[:, None]
        steps = visit.repeat_interleave(sup, 1).cpu()
        for j in range(s_max * sup):
            blk = steps[:, j].nonzero()[:, 0].to(dev)
            if not blk.numel():
                continue
            c = sup_ids[blk, j // sup].long() * sup + j % sup     # [b]
            t_star, g = ray_gaussian_response(ob[blk], db[blk], sc.means[c],
                                              sc.cov_inv[c])   # [b, rb, K]
            alpha = torch.clamp_max(sc.opacity[c][:, None, :]
                                    * torch.exp(-g), 0.99)
            valid = ((g <= cfg.g_cutoff) & (alpha > cfg.alpha_threshold)
                     & (t_star > lo_b[blk]) & (t_star < hi_b[blk]))
            slot = (c[:, None] * K + member)[:, None, :]          # [b, 1, K]
            kd[blk], ka[blk], ki[blk] = merge_nearest(
                kd[blk], ka[blk], ki[blk],
                torch.where(valid, t_star, init_d),
                torch.where(valid, alpha, 0.0), slot)
        kd, ka, ki = kd.reshape(R, k), ka.reshape(R, k), ki.reshape(R, k)
        count = (kd < init_d).sum(-1, dtype=torch.int32)
        new_trans, new_color, new_front = finish_pass(
            trans, color, front, kd, ka, colors[ki], count)
        live = ~done
        trans = torch.where(live, new_trans, trans)
        color = torch.where(live[:, None], new_color, color)
        front = torch.where(live, new_front, front)
        hits = hits + torch.where(live, count, torch.zeros_like(count))
        done = done | (count == 0) | (hits >= cfg.max_passes * k)
    return trans[:R0], color[:R0], hits[:R0], overflow
