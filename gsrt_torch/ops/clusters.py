"""Morton clusters of primitives and their bundle traversal (counterpart
of `gsrt.ops.clusters`).

Primitives are ordered by the Morton code of their AABB centres and packed
into M clusters of k members (M a multiple of `sup`); each cluster and
each run of `sup` clusters (a super-cluster) gets an AABB over its real
members. The sort is stable, as `jnp.argsort` is, so `order` equals the
JAX package's exactly: slots index through it.

`traverse_clusters` walks a ray bundle through them as the JAX package's
`lax.scan` and `lax.cond`s do: every super-cluster is slab-tested against
all rays, and only where some ray enters it are its clusters tested, and
only where some ray enters a cluster is it intersected densely. Each
branch reads one bool from the device. The counters are whole-bundle
totals and equal the JAX package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gsrt_torch.ops.morton import morton3d


class Clusters(NamedTuple):
    cl_min: torch.Tensor     # [M, 3]
    cl_max: torch.Tensor     # [M, 3]
    sup_min: torch.Tensor    # [MS, 3]
    sup_max: torch.Tensor    # [MS, 3]
    valid: torch.Tensor      # [M, K] bool — padding slots are False
    sup: int                 # clusters per super-cluster

    @property
    def m(self) -> int:
        return self.cl_min.shape[0]

    @property
    def k(self) -> int:
        return self.valid.shape[1]


def build_clusters(aabb_min, aabb_max, k: int = 64, sup: int = 8):
    """Cluster [N, 3] primitive AABBs by the Morton order of their centres.
    Returns (Clusters, order [M·k] int32): gather indices into the original
    arrays, the padding slots repeating the last primitive."""
    n = aabb_min.shape[0]
    dev = aabb_min.device
    centers = 0.5 * (aabb_min + aabb_max)
    order = torch.argsort(morton3d(centers), stable=True).to(torch.int32)
    m = -(-n // k)
    m = -(-m // sup) * sup
    pad = m * k - n
    slot_valid = (torch.arange(m * k, device=dev) < n).reshape(m, k)
    order_p = torch.cat([order, order[-1:].expand(pad)])
    idx = order_p.long()
    bmin = aabb_min[idx].reshape(m, k, 3)
    bmax = aabb_max[idx].reshape(m, k, 3)
    inf = torch.full_like(bmin, float("inf"))
    cl_min = torch.where(slot_valid[..., None], bmin, inf).amin(1)
    cl_max = torch.where(slot_valid[..., None], bmax, -inf).amax(1)
    sup_min = cl_min.reshape(m // sup, sup, 3).amin(1)
    sup_max = cl_max.reshape(m // sup, sup, 3).amax(1)
    return (Clusters(cl_min=cl_min, cl_max=cl_max, sup_min=sup_min,
                     sup_max=sup_max, valid=slot_valid, sup=sup),
            order_p)


def ray_aabb_hit(orig, inv_d, bmin, bmax, t_lo, t_hi):
    """Slab test: orig, inv_d [..., 3] and bmin, bmax [..., 3] broadcast
    against each other, t_lo, t_hi the rays' windows (broadcast likewise).
    True where the ray's [t_lo, t_hi] meets the box."""
    lo = (bmin - orig) * inv_d
    hi = (bmax - orig) * inv_d
    t_near = torch.minimum(lo, hi).amax(-1)
    t_far = torch.maximum(lo, hi).amin(-1)
    return (t_near <= t_far) & (t_far >= t_lo) & (t_near <= t_hi)


def safe_inv_dir(dirn):
    """1 / dirn with components below 1e-12 in size replaced by ±1e-12."""
    tiny = torch.where(dirn >= 0, 1e-12, -1e-12)
    return 1.0 / torch.where(dirn.abs() > 1e-12, dirn, tiny)


def traverse_clusters(clusters: Clusters, orig, dirn, t_min, carry0,
                      cluster_fn: Callable, t_hi_fn: Callable):
    """Scan every super-cluster and, inside the ones some ray enters,
    every cluster; cluster_fn(c, carry) → carry runs for each cluster some
    ray enters, t_hi_fn(carry) → [R] bounds the slab tests from above.
    t_min is [R]. Returns (carry, aabb_tests, clusters_tested), the
    counters as ints: R for each super-cluster and each cluster tested,
    R for each cluster intersected."""
    inv_d = safe_inv_dir(dirn)
    sup = clusters.sup
    ms = clusters.sup_min.shape[0]
    R = orig.shape[0]
    # fully padded clusters have (+inf, -inf) boxes, which the slab test
    # passes: masked, as in the JAX package
    cl_nonempty = clusters.valid.any(1)
    sup_nonempty = cl_nonempty.reshape(ms, sup).any(1).tolist()
    cl_nonempty = cl_nonempty.tolist()
    carry, aabb_n, leaf_n = carry0, 0, 0
    for s in range(ms):
        aabb_n += R
        if not sup_nonempty[s] or not bool(ray_aabb_hit(
                orig, inv_d, clusters.sup_min[s], clusters.sup_max[s],
                t_min, t_hi_fn(carry)).any()):
            continue
        for c in range(s * sup, (s + 1) * sup):
            aabb_n += R
            if cl_nonempty[c] and bool(ray_aabb_hit(
                    orig, inv_d, clusters.cl_min[c], clusters.cl_max[c],
                    t_min, t_hi_fn(carry)).any()):
                carry = cluster_fn(c, carry)
                leaf_n += R
    return carry, aabb_n, leaf_n


class TriClusters(NamedTuple):
    """Triangles packed into Morton clusters ([M, K, ...])."""
    clusters: Clusters
    v0: torch.Tensor          # [M, K, 3]
    v1: torch.Tensor
    v2: torch.Tensor
    mat: torch.Tensor         # [M, K] int32
    uv0: Optional[torch.Tensor] = None  # [M, K, 2] per-corner texcoords
    uv1: Optional[torch.Tensor] = None
    uv2: Optional[torch.Tensor] = None


def build_tri_clusters(v0, v1, v2, mat, uv0=None, uv1=None, uv2=None,
                       k: int = 64, sup: int = 8) -> TriClusters:
    """Morton-cluster a [N, 3] triangle soup and its per-triangle fields."""
    bmin = torch.minimum(torch.minimum(v0, v1), v2)
    bmax = torch.maximum(torch.maximum(v0, v1), v2)
    clusters, order = build_clusters(bmin, bmax, k=k, sup=sup)
    m, idx = clusters.m, order.long()

    def g(a, w):
        return None if a is None else a[idx].reshape(m, k, w)

    return TriClusters(clusters=clusters, v0=g(v0, 3), v1=g(v1, 3),
                       v2=g(v2, 3), mat=mat[idx].reshape(m, k),
                       uv0=g(uv0, 2), uv1=g(uv1, 2), uv2=g(uv2, 2))


def closest_hit_tri_clusters(tc: TriClusters, orig, dirn, t_min, t_max):
    """Bundle nearest triangle hit. t_min/t_max: scalars, [R] or [R, 1].
    Returns (t [R], cluster [R], k [R], hit [R], aabb_tests,
    clusters_tested); the caller looks the triangle up by (cluster, k).
    A cluster's hit replaces a ray's best only when strictly nearer."""
    from gsrt_torch.ops.primitives import ray_triangle
    R = orig.shape[0]
    dev = orig.device
    cl = tc.clusters

    def row(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.reshape(-1).expand(R) if x.dim() else x.expand(R)
    tmin_row, tmax_row = row(t_min), row(t_max)
    t_min, t_max = tmin_row[:, None], tmax_row[:, None]
    inf = float("inf")

    def cluster_fn(c, carry):
        best_t, best_c, best_k = carry
        t, _, _ = ray_triangle(orig, dirn, tc.v0[c], tc.v1[c], tc.v2[c],
                               t_min, t_max)                   # [R, K]
        t = torch.where(cl.valid[c][None, :], t, torch.full_like(t, inf))
        ki = t.argmin(-1)
        ti = torch.gather(t, -1, ki[:, None])[:, 0]
        upd = ti < best_t
        return (torch.where(upd, ti, best_t),
                torch.where(upd, torch.full_like(best_c, c), best_c),
                torch.where(upd, ki.to(torch.int32), best_k))

    carry0 = (torch.full((R,), inf, device=dev),
              torch.zeros((R,), dtype=torch.int32, device=dev),
              torch.zeros((R,), dtype=torch.int32, device=dev))
    (best_t, best_c, best_k), aabb_n, leaf_n = traverse_clusters(
        cl, orig, dirn, tmin_row, carry0, cluster_fn,
        # bounded by the caller's t_max too, so range-limited bundles do
        # not walk the whole scene while hitless
        lambda c: torch.minimum(c[0], tmax_row))
    hit = torch.isfinite(best_t) & (best_t < tmax_row)
    return best_t, best_c, best_k, hit, aabb_n, leaf_n
