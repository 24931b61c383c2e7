"""Plain PyTorch reference of the ray-traced splat frame: the reference
repo's multi-pass k-buffer (GaussTracing.rgen:22-76, the k = 8 nearest
accepted splats beyond the ray's depth front a pass, composited front to
back, the front advanced, passes until one finds nothing) through the
ray-space response.

It imports nothing of the program. From the benchmark's own inputs (the
splat parameters, the view, the configuration's constants) it works out
again the rays, the SH colours, the inverse covariances, the response and
the passes. A ray x(t) = o + t·d (o the eye, d the unit direction through
a pixel centre at integer coordinates) meets a splat where
q(t) = (x − μ)ᵀΣ⁻¹(x − μ) is least, at t* = −(dᵀΣ⁻¹m)/(dᵀΣ⁻¹d), m = o − μ;
there g = ½·q(t*) and alpha = min(opacity·e⁻ᵍ, 0.99). A hit is accepted
when g ≤ g_cutoff, alpha > alpha_threshold (so splats at or under it never
are) and t_min < t* < min(t_max, init_depth). Each pass takes, beyond the
front, the k accepted hits of least (t*, splat index) and the front moves
to the last of them, so hits tied with it that did not fit are dropped
(the next pass takes t* > front only); a ray stops on a pass that finds
nothing or once it has blended max_passes·k hits. Colour is degree-3 SH
(`splats.sh_color`) at the direction from the eye to the splat's centre.

How it runs, for clarity and to fit: every checked ray against every
splat, rays in blocks and splats in chunks; a conservative bounding sphere
(radius √(2·g_max·tr Σ), tr Σ ≥ its largest eigenvalue) drops the pairs
whose line passes farther from the centre, compared in squares with a
margin far above float32's rounding; the pairs left are evaluated
exactly, every accepted hit collected, each ray's hits sorted by
(t*, index) and the passes run over the sorted lists.

`dtype` is the arithmetic of the rays, response and composite (float32 is
the reference; the control computes them in bfloat16, with the same
float32 sphere cull); `order="index"` composites each pass's hits in
ascending splat index, the order a sweep meets them, instead of by t*
(a fault the control reads).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.splats import sh_color

ALPHA_CLAMP = 0.99
BLOCK_RAYS = 1024         # rays a block
CHUNK_SPLATS = 1 << 18    # splats a chunk of the sphere cull
CULL_MARGIN = 1e-5        # of |m|², added to the sphere's r²


def constants(render: dict) -> dict:
    """The trace's constants from a configuration's `render` group."""
    c = {k: render[k] for k in ("k", "g_cutoff", "alpha_threshold",
                                "max_passes", "t_min")}
    c["t_max"] = min(render["t_max"], render["init_depth"])
    return c


def rays(view, pixels, device, dtype=torch.float32):
    """(eye [3], unit directions [P, 3]) through the centres of the
    pixels (flat indices, row by row) of a scene.View."""
    V = torch.as_tensor(view.view, device=device).to(dtype)
    R, t = V[:3, :3], V[:3, 3]
    f = lambda v: torch.tensor(v, device=device, dtype=dtype)  # noqa: E731
    x = (pixels % view.width).to(dtype)
    y = (pixels // view.width).to(dtype)
    dx = (x - f(view.cx)) / f(view.fx)
    dy = (y - f(view.cy)) / f(view.fy)
    d = [R[0, i] * dx + R[1, i] * dy + R[2, i] for i in range(3)]
    inv = 1.0 / torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    eye = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])
    return eye, torch.stack([c * inv for c in d], -1)


def inverse_cov(cov6):
    """[N, 6] upper-triangular Σ → Σ⁻¹ by the adjugate."""
    a, b, c, d, e, f = cov6.unbind(-1)
    A, B, C = d * f - e * e, c * e - b * f, b * e - c * d
    inv = 1.0 / (a * A + b * B + c * C)
    return torch.stack([A * inv, B * inv, C * inv, (a * f - c * c) * inv,
                        (b * c - a * e) * inv, (a * d - b * b) * inv], -1)


def response(o, d, mu, ci):
    """t* and g of rays (o, d) [P, 3] against splats mu [P, 3], ci [P, 6]
    (pairwise rows)."""
    mx, my, mz = (o - mu).unbind(-1)
    dx, dy, dz = d.unbind(-1)
    i0, i1, i2, i3, i4, i5 = ci.unbind(-1)
    sx = i0 * dx + i1 * dy + i2 * dz
    sy = i1 * dx + i3 * dy + i4 * dz
    sz = i2 * dx + i4 * dy + i5 * dz
    d_sd = torch.clamp_min(dx * sx + dy * sy + dz * sz, 1e-12)
    m_sd = mx * sx + my * sy + mz * sz
    m_sm = mx * (i0 * mx + i1 * my + i2 * mz) \
        + my * (i1 * mx + i3 * my + i4 * mz) \
        + mz * (i2 * mx + i4 * my + i5 * mz)
    t_star = -m_sd / d_sd
    return t_star, 0.5 * torch.clamp_min(m_sm - m_sd * m_sd / d_sd, 0.0)


def _hits(eye, dirs, means, cov_inv, op, r2, consts, dtype):
    """Every accepted hit of the rays: (ray, t*, splat, alpha), sorted by
    ray, t*, splat."""
    m = means.float() - eye.float()                    # [N, 3]
    mm = (m * m).sum(-1)
    lim = mm - r2 - CULL_MARGIN * mm                   # line distance test
    inside = mm <= r2
    found = []
    for c0 in range(0, means.shape[0], CHUNK_SPLATS):
        sl = slice(c0, c0 + CHUNK_SPLATS)
        dm = dirs.float() @ m[sl].T                    # [B, S]
        ray, j = ((dm * dm >= lim[sl]) | inside[sl]).nonzero().unbind(1)
        j = j + c0
        t_star, g = response(eye.to(dtype)[None], dirs[ray].to(dtype),
                             means[j], cov_inv[j])
        alpha = torch.clamp_max(op[j] * torch.exp(-g), ALPHA_CLAMP)
        ok = ((g <= consts["g_cutoff"])
              & (alpha > consts["alpha_threshold"])
              & (t_star > consts["t_min"]) & (t_star < consts["t_max"]))
        found.append((ray[ok], t_star[ok], j[ok], alpha[ok]))
    ray, t, j, a = (torch.cat(x) for x in zip(*found))
    s = torch.argsort(j, stable=True)
    s = s[torch.argsort(t[s].float(), stable=True)]
    s = s[torch.argsort(ray[s], stable=True)]
    return ray[s], t[s], j[s], a[s]


def _passes(ray, t, j, a, colors, B: int, consts, dtype, order: str):
    """The passes over each ray's sorted hits: (trans [B], color [B, 3],
    hits [B])."""
    dev = colors.device
    k, max_hits = consts["k"], consts["max_passes"] * consts["k"]
    n = torch.bincount(ray, minlength=B)
    L = max(int(n.max()) if n.numel() else 0, 1)
    first = torch.cumsum(n, 0) - n
    col = torch.arange(ray.numel(), device=dev) - first[ray]
    tp = torch.full((B, L + k), math.inf, device=dev)
    ap = torch.zeros((B, L + k), dtype=dtype, device=dev)
    jp = torch.zeros((B, L + k), dtype=torch.long, device=dev)
    tp[ray, col], ap[ray, col], jp[ray, col] = t.float(), a, j
    rows = torch.arange(B, device=dev)[:, None]
    front = torch.zeros(B, device=dev)
    trans = torch.ones(B, dtype=dtype, device=dev)
    color = torch.zeros((B, 3), dtype=dtype, device=dev)
    hits = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    slot = torch.arange(k, device=dev)[None]
    while not bool(done.all()):
        lo = torch.clamp_min(front, consts["t_min"])
        pos = torch.searchsorted(tp, lo[:, None], right=True)     # > front
        take = torch.clamp_max(n[:, None] - pos, k)[:, 0]
        take = torch.where(done, 0, take)
        sel = slot < take[:, None]                                 # [B, k]
        e = pos + slot
        pa, pj = ap[rows, e], jp[rows, e]
        if order == "index":
            by = torch.argsort(torch.where(sel, pj, pj.new_tensor(
                1 << 62)), 1)
            pa, pj = pa.gather(1, by), pj.gather(1, by)
        for q in range(k):
            s, aq = sel[:, q], pa[:, q]
            w = aq * trans
            color = torch.where(s[:, None], color + w[:, None]
                                * colors[pj[:, q]], color)
            trans = torch.where(s, trans * (1.0 - aq), trans)
        last = tp[rows[:, 0], (pos[:, 0] + take - 1).clamp_min(0)]
        front = torch.where(take > 0, last, front)
        hits += take
        done |= (take == 0) | (hits >= max_hits)
    return trans, color, hits


def trace(cloud, cov6, view, pixels, consts: dict, *,
          dtype=torch.float32, order: str = "depth") -> dict:
    """The reference at the given pixels (flat indices) of `view`: trans
    [P], color [P, 3] (float32) and hits [P] (int64). cloud is a
    scene.Cloud, consts `constants(config["render"])`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = cloud.means.device
    with torch.no_grad():
        keep = (cloud.opacity > consts["alpha_threshold"]).nonzero()[:, 0]
        cov = cov6[keep].float()
        op = cloud.opacity[keep].float()
        g_max = torch.clamp(torch.log(op / consts["alpha_threshold"]), 0.0,
                            consts["g_cutoff"])
        r2 = (2.0 * g_max * (cov[:, 0] + cov[:, 3] + cov[:, 5])) * 1.0201
        means = cloud.means[keep].to(dtype)
        cov_inv = inverse_cov(cov6[keep].to(dtype))
        eye, dirs = rays(view, pixels, dev, dtype)
        to_eye = cloud.means[keep].float() - eye.float()
        to_eye = to_eye / torch.clamp_min(
            torch.sqrt((to_eye * to_eye).sum(-1, keepdim=True)), 1e-9)
        colors = sh_color(cloud.sh[keep].to(dtype), to_eye.to(dtype))
        P = pixels.shape[0]
        out = {"trans": torch.ones(P, device=dev),
               "color": torch.zeros((P, 3), device=dev),
               "hits": torch.zeros(P, dtype=torch.long, device=dev)}
        for b0 in range(0, P, BLOCK_RAYS):
            d = dirs[b0:b0 + BLOCK_RAYS]
            ray, t, j, a = _hits(eye, d, means, cov_inv, op.to(dtype), r2,
                                 consts, dtype)
            tr, cl, h = _passes(ray, t, j, a, colors, d.shape[0], consts,
                                dtype, order)
            out["trans"][b0:b0 + BLOCK_RAYS] = tr.float()
            out["color"][b0:b0 + BLOCK_RAYS] = cl.float()
            out["hits"][b0:b0 + BLOCK_RAYS] = h
        return out
