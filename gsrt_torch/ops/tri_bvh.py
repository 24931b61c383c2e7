"""Per-ray BVH closest hit over the triangle table (no TPU counterpart).

`ops.tri_kernel`'s block walk suits coherent bundles: a block of rays
shares one front-to-back list of super-clusters and tests whole clusters
densely. Past the first bounce of a path the rays scatter in every
direction, and a block's list holds most of the scene. Here every ray
walks a binary tree of its own instead.

1. Build (`build_tri_bvh`, once per scene; `path_tracer.with_tri_table`
   attaches it to the table as `TriTable.bvh`): leaves are aligned runs
   of LEAF = 4 slots of the Morton-ordered table, so slots keep their
   numbering and `order[slot]` still names the triangle. A leaf's box
   bounds its real triangles (padding slots left out) as the table holds
   them (v0, v0 + e1, v0 + e2), widened by BOX_PAD of the scene's extent
   on every side: Möller–Trumbore rounds, and may accept a ray a little
   outside the triangle or at a t a little before the box's entry.
   BOX_PAD is measured, not derived from that rounding, which no finite
   pad bounds: as a ray turns parallel to a triangle, det nears its
   1e-12 floor and u, v and t lose their digits. Unpadded, the tests'
   rays aimed at shared edges lose hits; padded, they lose none. The
   internal nodes are the Karras tree of `ops.bvh.build_lbvh` over the
   leaf boxes, in `ops.bvh.node_records` (which `ops.splat_bvh`'s tree
   shares). A node record is 64 B (`nodes` [NI, 16] f32) and holds
   both children's boxes, so one fetch tests two children: lo x, hi x,
   lo y, hi y of child 0, the same of child 1, lo z, hi z of child 0 and
   of child 1, then both children's int32 ids (c ≥ 0 an internal node,
   c < 0 the leaf ~c) and two unused words. The root is node 0; its own
   box is `root_box`. The build raises if the tree is deeper than the
   kernel's stack (STACK).
2. Traverse (`closest_hit_bvh`): on a CUDA tensor the kernel
   `csrc/tri_bvh.cu`, on a CPU tensor `closest_hit_bvh_plain`.
   Semantics: the closest hit over all triangles, each tested as
   `tri_kernel._mt` tests it; a ray keeps the least (t, slot), so on
   equal t the smaller slot wins. A box is entered where the slab window
   [t_near, t_far · FAR_SCALE] (`ops.bvh.slab`) meets [t_min, min(t_max,
   best)], the far end scaled by 1 + 2γ₃ or more (Ize 2013) and t_near
   compared with ≤, so ties are visited. The tree gives the brute force's
   (t, slot) wherever a padded box holds the hit Möller–Trumbore accepts.
   That is measured, not guaranteed: on the tests' random, grazing,
   shared-edge, parked, windowed and axis-aligned rays every ray agrees;
   of rays grazing a room's smallest triangles (1e-7 to 1e-1 rad off
   their planes) about 0.04% lose a hit, each on a triangle the ray
   meets within 1e-5 of parallel.
3. `walk_bvh_plain` is the kernel's walk in tensor code, step by step:
   its t and slot are the kernel's, and its node and test counts are
   the kernel's counters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsrt_torch import _kernels
from gsrt_torch.ops.bvh import EMPTY, EPS, node_records, slab
from gsrt_torch.ops.tri_kernel import GEOM, K, PLAIN_PAIRS, TriTable, _mt

LEAF = 4            # slots a leaf: one float4 of each geometry row
STACK = 64          # the kernel's stack entries, the tree depth it takes
BOX_PAD = 1e-5      # leaf boxes widened by this share of the scene extent
CPU_PAIRS = 1 << 16  # the plain version's batch on the CPU, kept in cache


class TriBVH(NamedTuple):
    """The per-ray tree over a TriTable's leaves of LEAF slots."""
    nodes: torch.Tensor     # [NI, 16] f32 node records (module docstring)
    root_box: torch.Tensor  # [6] f32 lo xyz, hi xyz of the root
    depth: int              # internal nodes on the longest root-leaf path
    n_leaves: int


def _leaf_boxes(tt: TriTable):
    """[L, 3] lo and hi of each leaf's real triangles, unpadded."""
    n = tt.n_tris
    rows = tt.table.permute(1, 0, 2).reshape(GEOM, -1)[:, :n]  # [9, n]
    v0, e1, e2 = rows[0:3].T, rows[3:6].T, rows[6:9].T
    p1, p2 = v0 + e1, v0 + e2
    lo = torch.minimum(torch.minimum(v0, p1), p2)
    hi = torch.maximum(torch.maximum(v0, p1), p2)
    pad = (-n) % LEAF
    inf = torch.full((pad, 3), float("inf"), device=lo.device)
    lo = torch.cat([lo, inf]).reshape(-1, LEAF, 3).amin(1)
    hi = torch.cat([hi, -inf]).reshape(-1, LEAF, 3).amax(1)
    return lo, hi


def build_tri_bvh(tt: TriTable) -> TriBVH:
    """The per-ray tree over the table's leaves (module docstring)."""
    lo, hi = _leaf_boxes(tt)
    pad = BOX_PAD * float((hi.amax(0) - lo.amin(0)).amax())
    nodes, root_box, depth = node_records(lo - pad, hi + pad, STACK)
    return TriBVH(nodes=nodes, root_box=root_box, depth=depth,
                  n_leaves=lo.shape[0])


def _bound(x, R: int, device):
    """A bound of the rays' windows as the kernel takes it: (None, x) for
    a number, else (its [R] f32 rows, 0)."""
    if isinstance(x, (int, float)):
        return None, float(x)
    x = torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1)
    if x.numel() not in (1, R):
        raise ValueError(f"a bound of {x.numel()} values for {R} rays")
    return x.expand(R).contiguous(), 0.0


def _rays(orig, dirn, t_min, t_max):
    """The [8, R] rows ox oy oz dx dy dz tmin tmax."""
    R = orig.shape[0]
    f32 = dict(dtype=torch.float32, device=orig.device)
    rows = [torch.as_tensor(x, **f32).reshape(-1).expand(R)
            for x in (t_min, t_max)]
    return torch.stack([*orig.T, *dirn.T, *rows]).contiguous()


def closest_hit_bvh(tt: TriTable, orig, dirn, t_min, t_max, *,
                    counts: torch.Tensor | None = None):
    """Closest hit of each ray through the table's tree (the brute
    force's but where a ray meets its triangle all but parallel: module
    docstring). orig/dirn
    [R, 3]; t_min/t_max scalars, [R] or [R, 1]. Returns (t [R] (+inf on a
    miss), slot [R] into tt.order (0 on a miss), hit [R]). CUDA tensors
    launch `csrc/tri_bvh.cu`, CPU tensors run `closest_hit_bvh_plain`.
    `counts`, an int64 [3] CUDA tensor, receives the kernel's node
    records fetched, triangle tests and rays that entered the root box,
    added to what it holds."""
    if not orig.is_cuda:
        return closest_hit_bvh_plain(tt, orig, dirn, t_min, t_max)
    bvh = tt.bvh
    if bvh is None:
        raise ValueError("the table has no tree: build it with "
                         "build_tri_bvh (with_tri_table does)")
    dev = orig.device
    if not (tt.table.device == bvh.nodes.device == dirn.device == dev):
        raise ValueError("closest_hit_bvh takes the rays, table and tree "
                         "on one CUDA device")
    if counts is not None and not (counts.dtype == torch.int64 and
                                   counts.shape == (3,) and
                                   counts.device == dev):
        raise ValueError("counts is an int64 [3] tensor on the rays' "
                         "device")
    R = orig.shape[0]
    o = orig.to(torch.float32).contiguous()
    d = dirn.to(torch.float32).contiguous()
    if o.shape != (R, 3) or d.shape != (R, 3):
        raise ValueError("orig and dirn are [R, 3]")
    tmin_p, tmin_s = _bound(t_min, R, dev)
    tmax_p, tmax_s = _bound(t_max, R, dev)
    t = torch.empty(R, dtype=torch.float32, device=dev)
    slot = torch.empty(R, dtype=torch.int32, device=dev)
    work = torch.empty(1, dtype=torch.int32, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()       # noqa: E731
    table = tt.table.contiguous()
    with torch.cuda.device(dev):
        _kernels.TRI_BVH(bvh.nodes.data_ptr(), bvh.root_box.data_ptr(),
                         table.data_ptr(), o.data_ptr(), d.data_ptr(),
                         ptr(tmin_p), tmin_s, ptr(tmax_p), tmax_s, R,
                         work.data_ptr(), t.data_ptr(), slot.data_ptr(),
                         ptr(counts), _kernels.stream_ptr(o))
    return t, slot, torch.isfinite(t)


def closest_hit_bvh_plain(tt: TriTable, orig, dirn, t_min, t_max):
    """The plain version of `closest_hit_bvh` on any device: brute force,
    every ray against every slot the tree's leaves hold, PLAIN_PAIRS
    (ray, slot) products at a time, CPU_PAIRS on the CPU (its temporaries
    then stay in cache: 4x faster on a 3,000-triangle room). The result
    does not depend on the batch. Within a batch `min` takes the first
    least t; a later batch replaces it only where strictly nearer, so the
    least (t, slot) wins, as in the kernel, which gives the same but
    where a ray meets its triangle all but parallel (module docstring)."""
    n_slots = -(-tt.n_tris // LEAF) * LEAF
    geo = tt.table.permute(1, 0, 2).reshape(GEOM, -1)[None, :, :n_slots]
    ox, oy, oz, dx, dy, dz, tmin, tmax = (
        r[:, None] for r in _rays(orig, dirn, t_min, t_max))
    R = ox.shape[0]
    pairs = CPU_PAIRS if orig.device.type == "cpu" else PLAIN_PAIRS
    rb = max(1, min(R, pairs // n_slots))
    sb = max(1, min(n_slots, pairs // rb))
    bt = torch.full((R,), float("inf"), device=orig.device)
    bi = torch.zeros(R, dtype=torch.int64, device=orig.device)
    for r0 in range(0, R, rb):
        rs = slice(r0, r0 + rb)
        for s0 in range(0, n_slots, sb):
            t = _mt(ox[rs], oy[rs], oz[rs], dx[rs], dy[rs], dz[rs],
                    tmin[rs], tmax[rs], geo[..., s0:s0 + sb])
            tc, ic = t.min(-1)
            upd = tc < bt[rs]
            bt[rs] = torch.where(upd, tc, bt[rs])
            bi[rs] = torch.where(upd, ic + s0, bi[rs])
    return bt, bi.to(torch.int32), torch.isfinite(bt)


def walk_bvh_plain(tt: TriTable, orig, dirn, t_min, t_max):
    """The kernel's walk in tensor code, every ray a step at a time:
    (t [R], slot [R], counts [3] int64: node records fetched, triangle
    tests, rays that entered the root box). A step is one of a ray's
    node visits (nearer child first, the other pushed with its t_near),
    leaf tests or pops (an entry whose t_near is past the ray's window
    is dropped), as in the kernel's loop."""
    bvh = tt.bvh
    dev = orig.device
    ox, oy, oz, dx, dy, dz, tmin, tmax = _rays(orig, dirn, t_min, t_max)
    R = ox.shape[0]
    iv = [1.0 / torch.where(d.abs() < EPS, torch.full_like(d, EPS), d)
          for d in (dx, dy, dz)]
    nd = bvh.nodes
    boxes = torch.stack([nd[:, [0, 1, 2, 3, 8, 9]],
                         nd[:, [4, 5, 6, 7, 10, 11]]], 1)       # [NI, 2, 6]
    kids = nd[:, 12:14].contiguous().view(torch.int32).long()   # [NI, 2]
    rb = bvh.root_box
    root = rb[[0, 3, 1, 4, 2, 5]]
    geo = tt.table.reshape(-1, GEOM, K // LEAF, LEAF)  # [M, 9, 32, 4]
    bt = torch.full((R,), float("inf"), device=dev)
    bi = torch.zeros(R, dtype=torch.int64, device=dev)
    hit, _ = slab(root, (ox, oy, oz, tmin), iv, tmax)
    POP = EMPTY + 1
    cur = torch.where(hit, 0, EMPTY).long()
    stack_c = torch.zeros((R, STACK), dtype=torch.long, device=dev)
    stack_t = torch.zeros((R, STACK), device=dev)
    sp = torch.zeros(R, dtype=torch.long, device=dev)
    n_nodes = n_tests = 0
    while bool((cur != EMPTY).any()):
        lim = torch.minimum(tmax, bt)
        # a pop: the top entry, kept if its t_near is inside the window
        p = (cur == POP).nonzero()[:, 0]
        if p.numel():
            empty = sp[p] == 0
            top = torch.clamp_min(sp[p] - 1, 0)
            keep = ~empty & (stack_t[p, top] <= lim[p])
            cur[p] = torch.where(empty, EMPTY, torch.where(
                keep, stack_c[p, top], POP))
            sp[p] = top
        # a node: its children tested, the nearer taken, the other pushed
        a = (cur >= 0).nonzero()[:, 0]
        if a.numel():
            n_nodes += a.numel()
            c = cur[a]
            ray = (ox[a, None], oy[a, None], oz[a, None], tmin[a, None])
            h, tn = slab(boxes[c], ray, [v[a, None] for v in iv],
                          lim[a, None])
            k = kids[c]
            swap = tn[:, 1] < tn[:, 0]
            both = h[:, 0] & h[:, 1]
            near = torch.where(swap, k[:, 1], k[:, 0])
            far = torch.where(swap, k[:, 0], k[:, 1])
            far_t = torch.where(swap, tn[:, 0], tn[:, 1])
            one = torch.where(h[:, 0], k[:, 0], k[:, 1])
            cur[a] = torch.where(both, near, torch.where(
                h[:, 0] | h[:, 1], one, POP))
            pa, ps = a[both], sp[a][both]
            stack_c[pa, ps], stack_t[pa, ps] = far[both], far_t[both]
            sp[pa] += 1
        # a leaf: its LEAF slots tested, then a pop
        f = ((cur < 0) & (cur > POP)).nonzero()[:, 0]
        if f.numel():
            n_tests += LEAF * f.numel()
            leaf = ~cur[f]
            g = geo[leaf // (K // LEAF), :, leaf % (K // LEAF)]   # [F, 9, 4]
            t = _mt(*(x[f, None] for x in (ox, oy, oz, dx, dy, dz, tmin,
                                           tmax)), g)
            slot = leaf[:, None] * LEAF + torch.arange(LEAF, device=dev)
            for j in range(LEAF):
                b0, i0 = bt[f], bi[f]
                upd = (t[:, j] < b0) | ((t[:, j] == b0) & (slot[:, j] < i0))
                bt[f] = torch.where(upd, t[:, j], b0)
                bi[f] = torch.where(upd, slot[:, j], i0)
            cur[f] = POP
    counts = torch.tensor([n_nodes, n_tests, int(hit.sum())],
                          dtype=torch.int64)
    return bt, bi.to(torch.int32), counts
