"""LBVH: a linear BVH over primitive AABBs (counterpart of
`gsrt.ops.bvh`).

Build: Karras' binary radix tree over the stably sorted Morton codes of
the boxes' centres, every internal node found on its own by searches over
the codes (duplicate codes fall back to index bits), node boxes as range
min / max over sparse tables. Traversal: per-ray explicit stacks, run as
a wavefront over dense [R, stack_depth] stacks: every ray whose stack is
not empty pops one entry a step, a leaf calls `leaf_fn` and a node pushes
both children where the ray meets its box, until every stack is empty
(any hit: or every ray has a hit). Each ray takes the JAX package's
per-ray `while_loop` steps, so `nodes_visited` equals its.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from gsrt_torch.ops.morton import morton3d


class LBVH(NamedTuple):
    left: torch.Tensor        # [N-1] int32 child index (root = node 0)
    right: torch.Tensor       # [N-1] int32
    left_leaf: torch.Tensor   # [N-1] bool: the child indexes leaves
    right_leaf: torch.Tensor  # [N-1] bool
    node_min: torch.Tensor    # [N-1, 3]
    node_max: torch.Tensor    # [N-1, 3]
    leaf_prim: torch.Tensor   # [N] int32 primitive id of each leaf
    leaf_min: torch.Tensor    # [N, 3]
    leaf_max: torch.Tensor    # [N, 3]

    @property
    def n_leaves(self) -> int:
        return self.leaf_prim.shape[0]


def _bit_length(x):
    """Bits of each non-negative int64 below 2³²."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + big * s
        x = torch.where(big, x >> s, x)
    return n + (x > 0)


def _delta(codes, i, j, n):
    """Common-prefix length of the keys (code, index) at i and j; -1 out
    of range."""
    valid = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, n - 1)
    x = codes[i] ^ codes[jc]
    d = torch.where(x == 0, 64 - _bit_length(i ^ jc), 32 - _bit_length(x))
    return torch.where(valid, d, torch.full_like(d, -1))


def build_lbvh(aabb_min, aabb_max) -> LBVH:
    """Build over [N, 3] primitive boxes, N ≥ 2."""
    n = aabb_min.shape[0]
    dev = aabb_min.device
    codes = morton3d(0.5 * (aabb_min + aabb_max))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    lmin, lmax = aabb_min[order], aabb_max[order]
    i = torch.arange(n - 1, device=dev)

    def delta(a, b):
        return _delta(codes, a, b, n)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i, i - d)
    l_max = torch.full_like(i, 2)           # range length by doubling
    for _ in range(32):
        grow = (delta(i, i + l_max * d) > delta_min) & (l_max < 2 * n)
        l_max = torch.where(grow, l_max * 2, l_max)
    length, t = torch.zeros_like(i), l_max  # then the exact one by halving
    for _ in range(32):
        t = torch.clamp_min(t // 2, 1)
        length = torch.where(delta(i, i + (length + t) * d) > delta_min,
                             length + t, length)
    j = i + length * d
    first, last = torch.minimum(i, j), torch.maximum(i, j)
    delta_node = delta(i, j)
    s, div = torch.zeros_like(i), 2         # the split, by halving steps
    for _ in range(32):
        t = -(-length // div)
        s = torch.where((t >= 1) & (delta(i, i + (s + t) * d) > delta_node),
                        s + t, s)
        div *= 2
    gamma = i + s * d + torch.clamp_max(d, 0)

    levels = max(1, (n - 1).bit_length())   # sparse tables of range min/max
    mins, maxs = [lmin], [lmax]
    for k in range(levels):
        w = 1 << k
        pad = torch.full((min(w, n), 3), float("inf"), device=dev)
        mins.append(torch.minimum(mins[-1],
                                  torch.cat([mins[-1][w:], pad])[:n]))
        maxs.append(torch.maximum(maxs[-1],
                                  torch.cat([maxs[-1][w:], -pad])[:n]))
    mins_t, maxs_t = torch.stack(mins), torch.stack(maxs)
    k = torch.clamp(_bit_length(last - first + 1) - 1, 0, levels)
    tail = torch.maximum(last + 1 - (1 << k), first)
    return LBVH(left=gamma.to(torch.int32), right=(gamma + 1).to(torch.int32),
                left_leaf=first == gamma, right_leaf=last == gamma + 1,
                node_min=torch.minimum(mins_t[k, first], mins_t[k, tail]),
                node_max=torch.maximum(maxs_t[k, first], maxs_t[k, tail]),
                leaf_prim=order.to(torch.int32), leaf_min=lmin,
                leaf_max=lmax)


def _ray_aabb(orig, inv_d, bmin, bmax, t_min, t_max):
    lo = (bmin - orig) * inv_d
    hi = (bmax - orig) * inv_d
    t_near = torch.minimum(lo, hi).amax(-1)
    t_far = torch.maximum(lo, hi).amin(-1)
    return (t_near <= t_far) & (t_far >= t_min) & (t_near <= t_max)


def bvh_traverse(bvh: LBVH, orig, dirn, t_min, t_max, leaf_fn: Callable,
                 init_payload, stack_depth: int = 64, any_hit: bool = False):
    """Stack traversal of R rays. leaf_fn(prim [A], orig [A, 3], dirn
    [A, 3], t_min, best_t [A], payload) → (new_best_t [A], new_payload)
    runs, batched, for the rays at a leaf whose box they enter; payload is
    a tensor or a tuple of tensors with a leading ray axis (scalars are
    broadcast to one a ray). Returns (best_t [R], payload, nodes_visited
    [R] int32)."""
    R = orig.shape[0]
    dev = orig.device
    f32 = dict(dtype=torch.float32, device=dev)
    tiny = torch.where(dirn >= 0, 1e-12, -1e-12)
    inv_d = 1.0 / torch.where(dirn.abs() > 1e-12, dirn, tiny)
    tmin_r = torch.as_tensor(t_min, **f32).expand(R)
    tmax_r = torch.as_tensor(t_max, **f32).expand(R)
    def per_ray(p):
        p = torch.as_tensor(p, device=dev)
        return (p.expand(R) if p.dim() == 0 else p).clone()
    single = not isinstance(init_payload, tuple)
    payload = [per_ray(p) for p in
               ((init_payload,) if single else init_payload)]
    stack = torch.zeros((R, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.ones(R, dtype=torch.int64, device=dev)   # the root, node 0
    best_t = tmax_r.clone()
    visited = torch.zeros(R, dtype=torch.int32, device=dev)
    while True:
        go = sp > 0
        if any_hit:
            go = go & (best_t >= tmax_r)
        rays = go.nonzero()[:, 0]
        if rays.numel() == 0:
            break
        sp[rays] -= 1
        entry = stack[rays, sp[rays]]
        visited[rays] += 1
        leaf = entry < 0
        lr, le = rays[leaf], -entry[leaf] - 1
        if lr.numel():
            o, d, bt = orig[lr], dirn[lr], best_t[lr]
            hit_box = _ray_aabb(o, inv_d[lr], bvh.leaf_min[le],
                                bvh.leaf_max[le], tmin_r[lr], bt)
            pl = tuple(p[lr] for p in payload)
            new_t, new_p = leaf_fn(bvh.leaf_prim[le].long(), o, d, t_min,
                                   bt, pl[0] if single else pl)
            best_t[lr] = torch.where(hit_box, new_t, bt)
            for p, old, new in zip(payload, pl, (new_p,) if single
                                   else new_p):
                keep = hit_box.reshape(-1, *[1] * (old.dim() - 1))
                p[lr] = torch.where(keep, new, old)
        nr, node = rays[~leaf], entry[~leaf]
        if nr.numel():
            hit = _ray_aabb(orig[nr], inv_d[nr], bvh.node_min[node],
                            bvh.node_max[node], tmin_r[nr], best_t[nr])
            push = hit & (sp[nr] + 2 <= stack_depth)
            pr, pn, ps = nr[push], node[push], sp[nr][push]
            for off, child, is_leaf in ((0, bvh.left, bvh.left_leaf),
                                        (1, bvh.right, bvh.right_leaf)):
                c = child[pn].long()
                stack[pr, ps + off] = torch.where(is_leaf[pn], -(c + 1), c)
            sp[pr] += 2
    return best_t, payload[0] if single else tuple(payload), visited
