"""Per-ray k-nearest hit buffer and front-to-back compositing (counterpart
of `gsrt.ops.kbuffer`): the paper's multi-pass k-buffer.

Semantics kept from the JAX package:
  * slots start at depth = init_depth, which is also the far clip: a hit
    at or past it is no hit;
  * with k slots the buffer holds the k smallest depths, ascending;
  * `count` (accepted hits this pass) is clamped to k;
  * transmittance: T *= Π(1 − αᵢ) over the buffered hits;
  * the depth front advances to the last buffered depth.

Ties. `jax.lax.top_k` puts the lower position first among equal keys;
`torch.topk` promises no order on CUDA. `nearest_k` therefore selects on
a unique int64 key — the depth's order-preserving int32 image in the high
half, the candidate's position in the low half — so equal depths are
taken lowest position first on every device, as in the JAX package.
`merge_nearest` applies it to the concatenation [buffer, chunk], which
is how the JAX package's multi-pass loops merge each chunk.

`trace_splat_passes` runs the passes of free rays over a set of splats
by brute force, chunk by chunk (`nearest_pass`).
"""

from __future__ import annotations

import torch

from gsrt_torch.core.config import RenderConfig
from gsrt_torch.ops.gaussian import ray_gaussian_response


def _order_key(depth: torch.Tensor) -> torch.Tensor:
    """int64 key ordering f32 depths (ties broken by position, lower
    first) along the last axis: the float's order-preserving int32 image
    in the high half, the position in the low half."""
    bits = (depth + 0.0).contiguous().view(torch.int32)   # -0.0 → +0.0
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    pos = torch.arange(depth.shape[-1], device=depth.device,
                       dtype=torch.int64)
    return (ordered.to(torch.int64) << 32) | pos


def nearest_k(depth: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest depths along the last axis (k ≤ its
    size), ascending, lower position first among equal depths."""
    return torch.topk(_order_key(depth), k, dim=-1, largest=False,
                      sorted=True).indices


def merge_nearest(kd, ka, ki, cd, ca, ci):
    """One chunk merged into the buffer: the k nearest of [buffer, chunk].

    kd, ka [..., k] buffer depth and alpha (ascending depth); ki [..., k]
    int64 id of each buffered hit (any value on empty slots). cd, ca
    [..., C] the chunk's candidates (depth init_depth, alpha 0 where
    invalid) and ci [..., C] (or [C]) their ids. Returns the new
    (kd, ka, ki)."""
    k = kd.shape[-1]
    md = torch.cat([kd, cd], -1)
    ma = torch.cat([ka, ca], -1)
    mi = torch.cat([ki, ci.expand(cd.shape)], -1)
    idx = nearest_k(md, k)
    return (torch.gather(md, -1, idx), torch.gather(ma, -1, idx),
            torch.gather(mi, -1, idx))


def topk_nearest(depth, alpha, valid, k: int, init_depth: float = 1e4):
    """The k nearest (smallest-depth) valid hits per ray.

    depth, alpha, valid: [..., M] over candidate splats. Returns (kd
    [..., k] ascending, ka [..., k], count [...] int32); empty slots
    carry depth init_depth and alpha 0."""
    big = torch.tensor(init_depth, dtype=depth.dtype, device=depth.device)
    # a hit at or past init_depth is indistinguishable from an empty slot:
    # init_depth doubles as the far clip
    valid = valid & (depth < big)
    d = torch.where(valid, depth, big)
    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    m = d.shape[-1]
    if m < k:   # pad with empty slots
        pad = [0, k - m]
        d = torch.nn.functional.pad(d, pad, value=init_depth)
        a = torch.nn.functional.pad(a, pad)
    idx = nearest_k(d, k)
    kd = torch.gather(d, -1, idx)
    ka = torch.where(kd < big, torch.gather(a, -1, idx),
                     torch.zeros_like(kd))
    count = torch.clamp_max(valid.sum(-1), k).to(torch.int32)
    return kd, ka, count


def composite_transmittance(trans, k_alpha, count):
    """T ← T·Π_{i<count}(1 − αᵢ)."""
    k = k_alpha.shape[-1]
    live = torch.arange(k, device=k_alpha.device) < count[..., None]
    factors = torch.where(live, 1.0 - k_alpha, torch.ones_like(k_alpha))
    return trans * torch.prod(factors, -1)


def advance_depth_front(front, k_depth, count):
    """front ← depth of the last buffered hit; unchanged on a miss."""
    k = k_depth.shape[-1]
    idx = torch.clamp(count.long() - 1, 0, k - 1)
    last = torch.gather(k_depth, -1, idx[..., None])[..., 0]
    return torch.where(count > 0, last, front)


def composite_color(trans, color, k_alpha, k_color, count):
    """Front-to-back blend of the buffered hits:
    C ← C + Σᵢ cᵢ·αᵢ·T·Π_{j<i}(1 − αⱼ);  T ← T·Π(1 − αᵢ).
    k_color [..., k, 3]. The sum over slots is f32 products and sums (the
    JAX package's einsum at HIGHEST precision), never a TF32 matmul."""
    k = k_alpha.shape[-1]
    live = torch.arange(k, device=k_alpha.device) < count[..., None]
    a = torch.where(live, k_alpha, torch.zeros_like(k_alpha))
    cum = torch.cumprod(1.0 - a, -1)
    excl = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
    w = a * excl * trans[..., None]                          # [..., k]
    color = color + (w[..., None] * k_color).sum(-2)
    return trans * cum[..., -1], color


def finish_pass(trans, color, front, k_depth, k_alpha, k_color, count):
    """A pass's end: the buffered hits blended front to back, the front
    advanced to the last of them. Returns (trans, color, front)."""
    trans, color = composite_color(trans, color, k_alpha, k_color, count)
    return trans, color, advance_depth_front(front, k_depth, count)


def ray_window(t_max, n_rays: int, cfg, dev) -> torch.Tensor:
    """Per-ray upper bound on t ([n_rays], cfg.t_max when None), clamped
    to cfg.init_depth: the k-buffer's empty-slot depth, past which hits
    would be dropped silently."""
    t = torch.as_tensor(cfg.t_max if t_max is None else t_max,
                        dtype=torch.float32, device=dev)
    return torch.clamp_max(t.expand(n_rays), float(cfg.init_depth))


def nearest_pass(n_rays: int, candidates, k: int, init_d: float, dev):
    """One k-buffer pass: every chunk's candidates (depth, alpha, id)
    merged into a fresh buffer. Returns (kd, ka, ki, count)."""
    kd = torch.full((n_rays, k), init_d, device=dev)
    ka = torch.zeros((n_rays, k), device=dev)
    ki = torch.zeros((n_rays, k), dtype=torch.int64, device=dev)
    for cd, ca, ci in candidates:
        kd, ka, ki = merge_nearest(kd, ka, ki, cd, ca, ci)
    return kd, ka, ki, (kd < init_d).sum(-1, dtype=torch.int32)


def trace_splat_passes(means, cov_inv, op, ids, colors, origins, dirs,
                       cfg: RenderConfig, tmax_r):
    """The multi-pass k-buffer of free rays over splats given as rows
    (`models.gaussian_rt.trace_gaussian_rays`' passes, and the plain
    version of `ops.splat_bvh`'s): per pass each ray's k nearest splats
    with the ray-space response g ≤ g_cutoff, alpha = min(op·e⁻ᵍ, 0.99)
    > alpha_threshold and t* in (max(front, t_min), tmax_r), blended by
    `finish_pass`; a ray is done on a pass that finds nothing or once it
    holds max_passes·k hits. means [N, 3], cov_inv [N, 6]
    (upper-triangular Σ⁻¹), op [N] (0 where a splat is left out), ids
    [N] int64 ascending, the splat index of each row, which names its
    colour (colors [·, 3]) and breaks ties (lowest first, as the rows'
    order); tmax_r [R] the rays' windows (`ray_window`). Returns (trans
    [R], color [R, 3], hits [R], passes [R]): passes counts the passes
    that found something."""
    dev = origins.device
    R, N = origins.shape[0], means.shape[0]
    init_d = float(cfg.init_depth)
    front = torch.zeros(R, device=dev)
    trans = torch.ones(R, device=dev)
    color = torch.zeros((R, 3), device=dev)
    hits = torch.zeros(R, dtype=torch.int32, device=dev)
    passes = torch.zeros(R, dtype=torch.int32, device=dev)
    live = torch.arange(R, device=dev) if N else torch.zeros(
        0, dtype=torch.long, device=dev)

    def candidates(o, d, lo, hi):
        for c0 in range(0, N, cfg.splat_chunk):
            sl = slice(c0, c0 + cfg.splat_chunk)
            t_star, g = ray_gaussian_response(o, d, means[sl], cov_inv[sl])
            alpha = torch.clamp_max(op[sl][None, :] * torch.exp(-g), 0.99)
            valid = ((g <= cfg.g_cutoff) & (alpha > cfg.alpha_threshold)
                     & (t_star > lo) & (t_star < hi))
            yield (torch.where(valid, t_star, init_d),
                   torch.where(valid, alpha, 0.0), ids[sl])

    while live.numel():
        fr = front[live]
        kd, ka, ki, count = nearest_pass(
            live.numel(),
            candidates(origins[live], dirs[live],
                       torch.clamp_min(fr, cfg.t_min)[:, None],
                       tmax_r[live][:, None]),
            cfg.k, init_d, dev)
        trans[live], color[live], front[live] = finish_pass(
            trans[live], color[live], fr, kd, ka, colors[ki], count)
        h = hits[live] + count
        hits[live] = h
        passes[live] += (count > 0).to(torch.int32)
        live = live[~((count == 0) | (h >= cfg.max_passes * cfg.k))]
    return trans, color, hits, passes
