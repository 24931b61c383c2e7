"""Per-ray BVH k-buffer tracing of a Gaussian cloud (no TPU counterpart).

`models.gaussian_rt.trace_gaussian_rays` tests every splat against every
ray each pass, and `ops.splat_clusters` plans visits for blocks of rays.
Here every ray walks a binary tree of its own, as the reference's
GaussTracing.rgen does through the hardware's BVH, with the multi-pass
k-buffer of `trace_gaussian_rays`:

1. Build (`build_splat_bvh`, once per scene): splats at or under
   cfg.alpha_threshold are left out (`trace_gaussian_rays` zeroes them);
   the rest are Morton-ordered by their means and packed into leaves,
   aligned runs of LEAF = 4 slots. A leaf's record (`slots` [L, ROWS,
   LEAF] f32) holds, a row each over its 4 slots, mean x, y, z, the
   upper-triangular Σ⁻¹ (6 rows), opacity, the splat's index (int32
   bits) and an unused row; padding slots have opacity 0 and index -1
   (a cloud of one leaf gets a second, empty one).
   A leaf's box bounds its splats' world boxes, mean ± the conservative
   radius `splat_clusters.splat_world_radius` (past it alpha is under the
   threshold in every direction), widened by BOX_PAD of the cloud's
   extent on every side: t* is rounded, and for a splat far from the
   origin and elongated against the ray its point may land a little
   outside the box. The internal nodes are `ops.bvh.node_records` over
   the leaf boxes, the tree `ops.tri_bvh` builds for triangles.
2. Trace (`trace_gaussian_rays_bvh`): on a CUDA tensor one launch of
   `csrc/splat_bvh.cu` for all passes, on a CPU tensor
   `trace_gaussian_rays_bvh_plain` (brute force over the tree's splats).
   Semantics (`trace_gaussian_rays`'): each pass takes the k nearest
   splats with g ≤ g_cutoff, alpha = min(opacity·e⁻ᵍ, 0.99) >
   alpha_threshold and t* in (max(front, t_min), t_max), equal t* lowest
   splat index first, and composites them front to back; the front moves
   to the last of them, so hits tied with it past the buffer are dropped;
   a ray is done on a pass that finds nothing or once hits ≥
   max_passes·k. One walk serves several passes: it keeps the KW nearest
   hits past max(front, t_min) by (t*, index), entering a box only while
   its slab window meets [max(front, t_min), lim], lim = t_max while the
   buffer has room, else its KW-th t* (compared with ≤, so ties are
   visited). The passes are replayed from that buffer, each the next k
   entries past the front, the entries tied with the new front skipped,
   until fewer than k are left: of a full buffer those are dropped and
   the ray walks again from its front (hits past the KW-th may belong to
   the pass); of a buffer that held every hit in the window they are the
   ray's last pass, and no empty walk follows. A ray whose window is
   empty (t_max ≤ max(0, t_min), or NaN: the path tracer's retired rays)
   makes no walk at all.
3. `walk_splat_bvh_plain` is the kernel's walk in tensor code, step by
   step: its outputs are the kernel's and its counts the kernel's
   counters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsrt_torch import _kernels
from gsrt_torch.core.config import RenderConfig
from gsrt_torch.core.types import GaussianCloud
from gsrt_torch.ops.bvh import EMPTY, EPS, node_records, slab
from gsrt_torch.ops.gaussian import invert_cov3d, ray_gaussian_response
from gsrt_torch.ops.kbuffer import finish_pass, ray_window, trace_splat_passes
from gsrt_torch.ops.morton import morton3d
from gsrt_torch.ops.splat_clusters import splat_world_radius

LEAF = 4            # slots a leaf: one float4 of each record row
ROWS = 12           # record rows a leaf (module docstring)
STACK = 64          # the kernel's stack entries, the tree depth it takes
K = 8               # the kernel's pass: cfg.k it takes
KW = 32             # the kernel's walk buffer: hits a walk keeps
BOX_PAD = 1e-4      # leaf boxes widened by this share of the cloud extent
_ID = 10            # the record row of the splat index
_NO_ID = (1 << 63) - 1   # an empty buffer entry's index in the walk


class SplatBVH(NamedTuple):
    """The per-ray tree over a cloud's splats (module docstring)."""
    nodes: torch.Tensor     # [NI, 16] f32 node records (ops.bvh)
    root_box: torch.Tensor  # [6] f32 lo xyz, hi xyz of the root
    slots: torch.Tensor     # [L, ROWS, LEAF] f32 leaf records
    depth: int              # internal nodes on the longest root-leaf path
    n_leaves: int
    n_splats: int           # splats the leaves hold (real slots)


def build_splat_bvh(cloud: GaussianCloud, cfg: RenderConfig) -> SplatBVH:
    """The per-ray tree over the cloud's splats above the alpha
    threshold (module docstring)."""
    dev = cloud.device
    keep = (cloud.opacity > cfg.alpha_threshold).nonzero()[:, 0]
    idx = keep[torch.argsort(morton3d(cloud.means[keep]), stable=True)] \
        if keep.numel() else keep
    n = idx.numel()
    # one leaf is paired with an empty one: the Karras tree needs two, and
    # a leaf it tested twice would put its hits in the buffer twice
    L = 2 if n and n <= LEAF else -(-n // LEAF)
    pad = L * LEAF - n
    means = cloud.means[idx]
    rows = torch.cat([means.T, invert_cov3d(cloud.cov3d[idx]).T,
                      cloud.opacity[idx][None],
                      idx.to(torch.int32).view(torch.float32)[None],
                      torch.zeros((1, n), device=dev)])
    fill = torch.zeros((ROWS, pad), device=dev)
    fill[_ID] = torch.tensor(-1, dtype=torch.int32).view(torch.float32)
    slots = torch.cat([rows, fill], 1).reshape(ROWS, L, LEAF)
    slots = slots.permute(1, 0, 2).contiguous()
    if n == 0:
        inf = float("inf")
        return SplatBVH(
            nodes=torch.zeros((0, 16), device=dev),
            root_box=torch.tensor([inf] * 3 + [-inf] * 3, device=dev),
            slots=slots, depth=0, n_leaves=0, n_splats=0)
    r = splat_world_radius(cloud, cfg)[idx][:, None]
    inf = torch.full((pad, 3), float("inf"), device=dev)
    lo = torch.cat([means - r, inf]).reshape(L, LEAF, 3).amin(1)
    hi = torch.cat([means + r, -inf]).reshape(L, LEAF, 3).amax(1)
    if n <= LEAF:                 # the empty leaf takes the other's box
        lo, hi = lo[:1].expand(2, 3), hi[:1].expand(2, 3)
    widen = BOX_PAD * float((hi.amax(0) - lo.amin(0)).amax())
    nodes, root_box, depth = node_records(lo - widen, hi + widen, STACK)
    return SplatBVH(nodes=nodes, root_box=root_box, slots=slots,
                    depth=depth, n_leaves=L, n_splats=n)


def _empty(R: int, dev):
    return (torch.ones(R, device=dev), torch.zeros((R, 3), device=dev),
            torch.zeros(R, dtype=torch.int32, device=dev),
            torch.zeros(R, dtype=torch.int32, device=dev))


def trace_gaussian_rays_bvh(tree: SplatBVH, origins, dirs,
                            cfg: RenderConfig, colors, t_max=None, *,
                            counts: torch.Tensor | None = None):
    """The k-buffer passes of each ray through the tree (module
    docstring). origins, dirs [R, 3] (dirs need not be unit); colors
    [N, 3] per splat of the cloud the tree was built from; t_max None
    (cfg.t_max) or per-ray [R], clamped to cfg.init_depth. Returns (trans
    [R], color [R, 3], hits [R] int32, passes [R] int32: the passes that
    found something). CUDA tensors launch `csrc/splat_bvh.cu` once (none
    for a tree or a batch that is empty), which takes cfg.k = K; CPU
    tensors run `trace_gaussian_rays_bvh_plain`. `counts`, an int64 [5]
    CUDA tensor, receives the kernel's node records fetched, response
    evaluations, walks (each from the root; none for a ray whose window
    is empty), hits blended and passes replayed (blended from a walk's
    buffer after the walk's own first pass), added to what it holds."""
    if not origins.is_cuda:
        return trace_gaussian_rays_bvh_plain(tree, origins, dirs, cfg,
                                             colors, t_max)
    dev = origins.device
    if cfg.k != K:
        raise ValueError(f"the kernel's buffer holds {K} hits, cfg.k is "
                         f"{cfg.k}")
    if not (tree.nodes.device == tree.slots.device == dirs.device ==
            colors.device == dev):
        raise ValueError("trace_gaussian_rays_bvh takes the rays, tree and "
                         "colours on one CUDA device")
    if counts is not None and not (counts.dtype == torch.int64 and
                                   counts.shape == (5,) and
                                   counts.device == dev):
        raise ValueError("counts is an int64 [5] tensor on the rays' "
                         "device")
    R = origins.shape[0]
    o = origins.to(torch.float32).contiguous()
    d = dirs.to(torch.float32).contiguous()
    c = colors.to(torch.float32).contiguous()
    if o.shape != (R, 3) or d.shape != (R, 3) or c.dim() != 2 or \
            c.shape[1] != 3:
        raise ValueError("origins and dirs are [R, 3], colors [N, 3]")
    trans, color, hits, passes = _empty(R, dev)
    if R == 0 or tree.n_leaves == 0:
        return trans, color, hits, passes
    if t_max is None:
        tmax_p, tmax_s = None, min(cfg.t_max, cfg.init_depth)
    else:
        tmax_p, tmax_s = ray_window(t_max, R, cfg, dev).contiguous(), 0.0
    work = torch.empty(1, dtype=torch.int32, device=dev)
    ptr = lambda x: 0 if x is None else x.data_ptr()       # noqa: E731
    with torch.cuda.device(dev):
        _kernels.SPLAT_BVH(
            tree.nodes.data_ptr(), tree.root_box.data_ptr(),
            tree.slots.data_ptr(), c.data_ptr(), o.data_ptr(), d.data_ptr(),
            cfg.t_min, ptr(tmax_p), tmax_s, R, cfg.max_passes * cfg.k,
            cfg.g_cutoff, cfg.alpha_threshold, work.data_ptr(),
            trans.data_ptr(), color.data_ptr(), hits.data_ptr(),
            passes.data_ptr(), ptr(counts), _kernels.stream_ptr(o))
    return trans, color, hits, passes


def _splats_by_index(tree: SplatBVH):
    """The tree's splats in ascending index: (means [n, 3], cov_inv
    [n, 6], opacity [n], index [n] int64)."""
    rows = tree.slots.permute(1, 0, 2).reshape(ROWS, -1)[:, :tree.n_splats]
    idx = rows[_ID].contiguous().view(torch.int32).long()
    by = torch.argsort(idx)
    return rows[0:3].T[by], rows[3:9].T[by], rows[9][by], idx[by]


def trace_gaussian_rays_bvh_plain(tree: SplatBVH, origins, dirs,
                                  cfg: RenderConfig, colors, t_max=None):
    """The plain version of `trace_gaussian_rays_bvh` on any device:
    `ops.kbuffer.trace_splat_passes`, the brute force of
    `trace_gaussian_rays`, over the splats the tree holds in ascending
    index. Same returns."""
    means, cov_inv, op, idx = _splats_by_index(tree)
    return trace_splat_passes(
        means, cov_inv, op, idx, colors, origins, dirs, cfg,
        ray_window(t_max, origins.shape[0], cfg, origins.device))


def _insert(kd, ka, ki, t, a, i, take):
    """Each row's buffer (kd, ka, ki [F, k], ascending (t*, index), empty
    entries (inf, 0, _NO_ID)) with the hit (t, a, i [F]) put in its place
    where `take`; the last entry falls off."""
    before = (kd < t[:, None]) | ((kd == t[:, None]) & (ki < i[:, None]))
    p = before.sum(1, keepdim=True)
    q = torch.arange(kd.shape[1], device=kd.device)[None]
    take = take[:, None] & (p < kd.shape[1])
    out = []
    for buf, new in ((kd, t), (ka, a), (ki, i)):
        shifted = torch.cat([buf[:, :1], buf[:, :-1]], 1)
        put = torch.where(q < p, buf, torch.where(q == p, new[:, None],
                                                  shifted))
        out.append(torch.where(take, put, buf))
    return out


def walk_splat_bvh_plain(tree: SplatBVH, origins, dirs, cfg: RenderConfig,
                         colors, t_max=None):
    """The kernel's walk in tensor code, every ray a step at a time:
    (trans [R], color [R, 3], hits [R], passes [R], counts [5] int64: node
    records fetched, response evaluations, walks, hits blended, passes
    replayed). A step is one of a ray's walk starts (the root box tested
    against [max(front, t_min), t_max], the buffer of KW entries
    emptied), node visits (nearer child first, the other pushed with its
    t_near), leaf tests (its LEAF slots in order, each accepted hit put in
    the buffer), pops (an entry whose t_near is past the window is
    dropped) or walk ends (passes of k entries replayed from the buffer,
    each composited by `ops.kbuffer.finish_pass`, as the module docstring
    says), as in the kernel's loop. Like the kernel, it takes k ≤ KW."""
    dev = origins.device
    R, k = origins.shape[0], cfg.k
    if k > KW:
        raise ValueError(f"the walk's buffer holds {KW} hits, cfg.k is {k}")
    W = KW
    trans, color, hits, passes = _empty(R, dev)
    if tree.n_leaves == 0 or R == 0:
        return trans, color, hits, passes, torch.zeros(5, dtype=torch.int64)
    o = origins.to(torch.float32)
    d = dirs.to(torch.float32)
    ox, oy, oz = o.T
    iv = [1.0 / torch.where(c.abs() < EPS, torch.full_like(c, EPS), c)
          for c in d.T]
    tmin = torch.tensor(cfg.t_min, dtype=torch.float32, device=dev)
    tmax = ray_window(t_max, R, cfg, dev)
    nd = tree.nodes
    boxes = torch.stack([nd[:, [0, 1, 2, 3, 8, 9]],
                         nd[:, [4, 5, 6, 7, 10, 11]]], 1)       # [NI, 2, 6]
    kids = nd[:, 12:14].contiguous().view(torch.int32).long()   # [NI, 2]
    root = tree.root_box[[0, 3, 1, 4, 2, 5]]
    slots = tree.slots
    max_hits = cfg.max_passes * k
    POP, START = EMPTY + 1, EMPTY + 2
    inf = float("inf")
    front = torch.zeros(R, device=dev)
    lo = torch.zeros(R, device=dev)
    kd = torch.full((R, W), inf, device=dev)
    ka = torch.zeros((R, W), device=dev)
    ki = torch.full((R, W), _NO_ID, dtype=torch.long, device=dev)
    q = torch.arange(W, device=dev)[None]
    cur = torch.full((R,), START, dtype=torch.long, device=dev)
    done = ~(torch.maximum(front, tmin) < tmax)     # an empty window
    stack_c = torch.zeros((R, STACK), dtype=torch.long, device=dev)
    stack_t = torch.zeros((R, STACK), device=dev)
    sp = torch.zeros(R, dtype=torch.long, device=dev)
    n_nodes = n_tests = n_walks = n_hits = n_replays = 0
    while not bool(done.all()):
        # a walk starts: the buffer emptied, the root tested
        s = ((cur == START) & ~done).nonzero()[:, 0]
        if s.numel():
            n_walks += s.numel()
            lo[s] = torch.maximum(front[s], tmin)
            kd[s], ka[s], ki[s] = inf, 0.0, _NO_ID
            ray = (ox[s], oy[s], oz[s], lo[s])
            h, _ = slab(root, ray, [v[s] for v in iv], tmax[s])
            cur[s] = torch.where(h, 0, EMPTY)
            sp[s] = 0
        lim = torch.minimum(tmax, kd[:, -1])
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
            ray = (ox[a, None], oy[a, None], oz[a, None], lo[a, None])
            h, tn = slab(boxes[c], ray, [v[a, None] for v in iv],
                          lim[a, None])
            kc = kids[c]
            swap = tn[:, 1] < tn[:, 0]
            both = h[:, 0] & h[:, 1]
            near = torch.where(swap, kc[:, 1], kc[:, 0])
            far = torch.where(swap, kc[:, 0], kc[:, 1])
            far_t = torch.where(swap, tn[:, 0], tn[:, 1])
            one = torch.where(h[:, 0], kc[:, 0], kc[:, 1])
            cur[a] = torch.where(both, near, torch.where(
                h[:, 0] | h[:, 1], one, POP))
            pa, ps = a[both], sp[a][both]
            stack_c[pa, ps], stack_t[pa, ps] = far[both], far_t[both]
            sp[pa] += 1
        # a leaf: its slots tested in order, each hit put in the buffer
        f = ((cur < 0) & (cur > START)).nonzero()[:, 0]
        if f.numel():
            n_tests += LEAF * f.numel()
            g = slots[~cur[f]]                                  # [F, 12, 4]
            t_star, resp = ray_gaussian_response(
                o[f, None], d[f, None], g[:, 0:3].transpose(1, 2),
                g[:, 3:9].transpose(1, 2))                      # [F, 1, 4]
            t_star, resp = t_star[:, 0], resp[:, 0]
            alpha = torch.clamp_max(g[:, 9] * torch.exp(-resp), 0.99)
            valid = ((resp <= cfg.g_cutoff) & (alpha > cfg.alpha_threshold)
                     & (t_star > lo[f, None]) & (t_star < tmax[f, None]))
            ids = g[:, _ID].contiguous().view(torch.int32).long()
            bd, ba, bi = kd[f], ka[f], ki[f]
            for j in range(LEAF):
                bd, ba, bi = _insert(bd, ba, bi, t_star[:, j], alpha[:, j],
                                     ids[:, j], valid[:, j])
            kd[f], ka[f], ki[f] = bd, ba, bi
            cur[f] = POP
        # a walk ends: its passes replayed from the buffer
        e = ((cur == EMPTY) & ~done).nonzero()[:, 0]
        if e.numel():
            ed, ea, ei = kd[e], ka[e], ki[e]
            m = (ed < inf).sum(1)
            full = m == W
            at = torch.zeros_like(m)            # the next entry
            own = torch.ones_like(full)         # the walk's own pass to come
            go = torch.ones_like(full)
            while bool(go.any()):
                left = m - at
                again = go & full & (left < k)  # walk again from the front
                take = go & ~again & (left > 0)
                count = torch.where(take, torch.clamp_max(left, k), 0)
                pos = torch.clamp_max(at[:, None] + q[:, :k], W - 1)
                td, ta, ti = (torch.gather(b, 1, pos) for b in (ed, ea, ei))
                c32 = count.to(torch.int32)
                tr, cl, fr = finish_pass(trans[e], color[e], front[e], td, ta,
                                         colors[torch.where(ti == _NO_ID, 0,
                                                            ti)], c32)
                trans[e] = torch.where(take, tr, trans[e])
                color[e] = torch.where(take[:, None], cl, color[e])
                front[e] = torch.where(take, fr, front[e])
                hits[e] += c32
                passes[e] += take.to(torch.int32)
                n_hits += int(count.sum())
                n_replays += int((take & ~own).sum())
                own &= ~take
                # the entries tied with the new front skipped
                at = at + count + torch.where(take, (
                    (ed == front[e][:, None]) & (q >= (at + count)[:, None])
                ).sum(1), 0)
                capped = take & (hits[e] >= max_hits)
                done[e] |= (go & ~again & ~take) | capped
                go = take & ~capped
            cur[e] = START
    counts = torch.tensor([n_nodes, n_tests, n_walks, n_hits, n_replays],
                          dtype=torch.int64)
    return trans, color, hits, passes, counts
