"""Morton clusters of primitives (counterpart of `gsrt.ops.clusters`'s
`build_clusters`, `ray_aabb_hit` and `safe_inv_dir`; the bundle
traversal `traverse_clusters` and `TriClusters` are not ported yet,
ROADMAP.md Queue 1 item D).

Primitives are ordered by the Morton code of their AABB centres and packed
into M clusters of k members (M a multiple of `sup`); each cluster and
each run of `sup` clusters (a super-cluster) gets an AABB over its real
members. The sort is stable, as `jnp.argsort` is, so `order` equals the
JAX package's exactly: slots index through it.
"""

from __future__ import annotations

from typing import NamedTuple

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
