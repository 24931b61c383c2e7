"""Plain PyTorch reference of the 3DGS splat render and its training step.

It imports nothing of the program. From the benchmark's own inputs (the
splat parameters, the view, the configuration's constants) it works out
again everything the port derives: the projection, the SH colour, the
footprints, the (tile, splat) pairs in depth order, the front-to-back
composite and where each tile saturates. It is written for clarity, not
speed: elementwise tensor code in blocks of tiles, so that it fits, and no
matrix product (TF32 never enters).

The render it defines (the 3DGS paper's, with the port's configuration
constants): a splat projects through the Jacobian of the pinhole map to
a 2D Gaussian with conic Q = Cov2D⁻¹; at a pixel centre p (integer
coordinates) its response is g = ½ (p − μ)ᵀ Q (p − μ) and its alpha
min(opacity · e^−g, 0.99), taken when 0 ≤ g ≤ g_cutoff and alpha >
alpha_threshold; splats are composited front to back in camera depth
(ties by splat index) until every pixel of a tile is at or below
term_eps. Colour is degree-3 SH at the direction from the camera to the
splat's centre, + ½, clamped at 0.

Every function takes a `dtype`: float32 is the reference; the control
computes the same in bfloat16.
"""

from __future__ import annotations

import math

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

# the configuration's constants (RenderConfig's defaults, standard conic)
CONSTS = dict(g_cutoff=5.6, alpha_threshold=1.0 / 255.0, alpha_clamp=0.99,
              term_eps=1e-4, t_min=1e-3, t_max=1e4, tile_w=32, tile_h=16)
PAIR_CHUNK = 128          # pairs of a tile taken per step of the composite
BLOCK_ELEMS = 1 << 24     # tiles × pixels × pairs held at once


def sh_color(sh, dirs, degree: int = 3):
    """[N, K, 3] coefficients, [N, 3] unit directions → [N, 3] RGB."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    c = lambda i: sh[:, i, :]
    r = C0 * c(0)
    if degree >= 1:
        r = r - C1 * y * c(1) + C1 * z * c(2) - C1 * x * c(3)
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        r = (r + C2[0] * x * y * c(4) + C2[1] * y * z * c(5)
             + C2[2] * (2 * zz - xx - yy) * c(6) + C2[3] * x * z * c(7)
             + C2[4] * (xx - yy) * c(8))
    if degree >= 3:
        r = (r + C3[0] * y * (3 * xx - yy) * c(9) + C3[1] * x * y * z * c(10)
             + C3[2] * y * (4 * zz - xx - yy) * c(11)
             + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * c(12)
             + C3[4] * x * (4 * zz - xx - yy) * c(13)
             + C3[5] * z * (xx - yy) * c(14)
             + C3[6] * x * (xx - 3 * yy) * c(15))
    return torch.clamp_min(r + 0.5, 0.0)


def project(means, cov6, opacity, sh, view, *, dtype=torch.float32,
            sh_degree: int = 3, consts=CONSTS):
    """Per-splat screen quantities: a dict of [N] tensors depth, mx, my,
    qa, qb, qc (the conic), ca, cc (Cov2D's diagonal), op, alive, and
    rgb [N, 3]. `view` is a scene.View."""
    dev = means.device
    V = torch.as_tensor(view.view, device=dev).to(dtype)
    R, t = V[:3, :3], V[:3, 3]
    m = means.to(dtype)
    pc = [m[:, 0] * R[i, 0] + m[:, 1] * R[i, 1] + m[:, 2] * R[i, 2] + t[i]
          for i in range(3)]
    x, y, z = pc
    in_front = z > 1e-4
    zs = torch.where(in_front, z, torch.ones_like(z))
    fx, fy = (torch.tensor(v, device=dev, dtype=dtype)
              for v in (view.fx, view.fy))
    mx = fx * x / zs + torch.tensor(view.cx, device=dev, dtype=dtype)
    my = fy * y / zs + torch.tensor(view.cy, device=dev, dtype=dtype)
    # T = J·W: the Jacobian of the pinhole map times the view rotation
    j00, j02 = fx / zs, -fx * x / (zs * zs)
    j11, j12 = fy / zs, -fy * y / (zs * zs)
    T0 = [j00 * R[0, k] + j02 * R[2, k] for k in range(3)]
    T1 = [j11 * R[1, k] + j12 * R[2, k] for k in range(3)]
    c = cov6.to(dtype)
    S = [[c[:, 0], c[:, 1], c[:, 2]], [c[:, 1], c[:, 3], c[:, 4]],
         [c[:, 2], c[:, 4], c[:, 5]]]
    ST0 = [S[i][0] * T0[0] + S[i][1] * T0[1] + S[i][2] * T0[2]
           for i in range(3)]
    ST1 = [S[i][0] * T1[0] + S[i][1] * T1[1] + S[i][2] * T1[2]
           for i in range(3)]
    ca = T0[0] * ST0[0] + T0[1] * ST0[1] + T0[2] * ST0[2]
    cb = T1[0] * ST0[0] + T1[1] * ST0[1] + T1[2] * ST0[2]
    cc = T1[0] * ST1[0] + T1[1] * ST1[1] + T1[2] * ST1[2]
    det = ca * cc - cb * cb
    ok = det > 1e-12
    inv = torch.where(ok, 1.0 / torch.clamp_min(det, 1e-12),
                      torch.zeros_like(det))
    op = opacity.to(dtype)
    depth = z
    alive = (in_front & ok & (op > consts["alpha_threshold"])
             & (depth > consts["t_min"]) & (depth < consts["t_max"]))
    eye = torch.as_tensor(view.position, device=dev).to(dtype)
    d = m - eye
    d = d / torch.clamp_min(torch.sqrt((d * d).sum(-1, keepdim=True)), 1e-9)
    rgb = sh_color(sh.to(dtype), d, sh_degree)
    return dict(depth=depth, mx=mx, my=my, qa=cc * inv, qb=-cb * inv,
                qc=ca * inv, ca=ca, cc=cc, op=op, alive=alive, rgb=rgb)


def tile_grid(width: int, height: int, consts=CONSTS):
    tw, th = consts["tile_w"], consts["tile_h"]
    return -(-width // tw), -(-height // th)


def bin_pairs(p: dict, width: int, height: int, consts=CONSTS):
    """(tile_start [T + 1] int64, splat [L] int64): every (tile, splat)
    pair whose footprint box, padded by a pixel, covers the tile, sorted
    by tile and, within a tile, by depth (ties by splat index). The box
    holds every pixel where alpha can pass the threshold, so no accepted
    (pixel, splat) is missed."""
    tw, th = consts["tile_w"], consts["tile_h"]
    ntx, nty = tile_grid(width, height, consts)
    f = lambda v: v.float()
    gmax = torch.clamp_min(torch.log(torch.clamp_min(
        f(p["op"]) / consts["alpha_threshold"], 1e-6)), 0.0)
    gmax = torch.clamp_max(gmax, consts["g_cutoff"])
    rx = torch.sqrt(torch.clamp_min(2.0 * gmax * f(p["ca"]), 0.0)) + 1.0
    ry = torch.sqrt(torch.clamp_min(2.0 * gmax * f(p["cc"]), 0.0)) + 1.0
    mx, my = f(p["mx"]), f(p["my"])
    on = ((mx + rx >= 0) & (mx - rx <= width - 1) & (my + ry >= 0)
          & (my - ry <= height - 1) & p["alive"])
    x0 = torch.clamp(torch.floor((mx - rx) / tw), 0, ntx - 1).long()
    x1 = torch.clamp(torch.floor((mx + rx) / tw), 0, ntx - 1).long()
    y0 = torch.clamp(torch.floor((my - ry) / th), 0, nty - 1).long()
    y1 = torch.clamp(torch.floor((my + ry) / th), 0, nty - 1).long()
    wspan = x1 - x0 + 1
    n_t = torch.where(on, wspan * (y1 - y0 + 1), torch.zeros_like(x0))
    key = torch.where(on, f(p["depth"]), torch.full_like(mx, math.inf))
    order = torch.argsort(key, stable=True)
    counts = n_t[order]
    splat = torch.repeat_interleave(order, counts)
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(splat.numel(), device=splat.device) - \
        torch.repeat_interleave(first, counts)
    w = wspan[splat]
    tile = (y0[splat] + k // w) * ntx + x0[splat] + k % w
    perm = torch.argsort(tile, stable=True)
    splat, tile = splat[perm], tile[perm]
    start = torch.zeros(ntx * nty + 1, dtype=torch.long, device=tile.device)
    start[1:] = torch.cumsum(torch.bincount(tile, minlength=ntx * nty), 0)
    return start, splat


def features(p: dict) -> torch.Tensor:
    """[N, 9]: mx, my, qa, qb, qc, op, r, g, b."""
    return torch.stack([p["mx"], p["my"], p["qa"], p["qb"], p["qc"],
                        p["op"], p["rgb"][:, 0], p["rgb"][:, 1],
                        p["rgb"][:, 2]], -1)


def _tile_pixels(tiles, width, height, consts, dtype):
    tw, th = consts["tile_w"], consts["tile_h"]
    ntx, _ = tile_grid(width, height, consts)
    dev = tiles.device
    lx = torch.arange(tw, device=dev).repeat(th)
    ly = torch.arange(th, device=dev).repeat_interleave(tw)
    x = (tiles % ntx)[:, None] * tw + lx[None, :]
    y = (tiles // ntx)[:, None] * th + ly[None, :]
    real = (x < width) & (y < height)
    return x.to(dtype), y.to(dtype), x, y, real


def _chunk(f, valid, px, py, consts):
    """One chunk of pairs for a block of tiles: f [B, C, 9] features,
    valid [B, C], px, py [B, P]. Returns (alpha [B, P, C] with the
    rejected pairs at 0, accept [B, P, C])."""
    dx = px[:, :, None] - f[:, None, :, 0]
    dy = py[:, :, None] - f[:, None, :, 1]
    qa, qb, qc = f[:, None, :, 2], f[:, None, :, 3], f[:, None, :, 4]
    g = 0.5 * (qa * dx * dx + 2.0 * qb * dx * dy + qc * dy * dy)
    alpha = torch.clamp_max(f[:, None, :, 5] * torch.exp(-g),
                            consts["alpha_clamp"])
    accept = (valid[:, None, :] & (g >= 0) & (g <= consts["g_cutoff"])
              & (alpha > consts["alpha_threshold"]))
    return torch.where(accept, alpha, torch.zeros_like(alpha)), accept


def composite(feat: torch.Tensor, start: torch.Tensor, splat: torch.Tensor,
              width: int, height: int, *, consts=CONSTS,
              dcolor: torch.Tensor | None = None, count: bool = False):
    """Front-to-back composite of every tile's pairs, in blocks of tiles
    and chunks of PAIR_CHUNK pairs, until each tile is saturated (all its
    pixels at or below term_eps) or out of pairs.

    Returns a dict: color [H, W, 3], trans [H, W] (feat's dtype); with
    `count`, per-tile `pairs_needed` (the pairs a tile walks up to and
    including the one that saturates it), `pairs_read` (those with a
    pixel that accepts them) and `accepted` ((pixel, pair) products
    accepted among them); with `dcolor` [H, W, 3], `grad` [N, 9], the
    gradient of Σ dcolor·color with respect to feat (the pairs' order and
    the stop are constants)."""
    dev, dtype = feat.device, feat.dtype
    tw, th = consts["tile_w"], consts["tile_h"]
    ntx, nty = tile_grid(width, height, consts)
    T, P, C = ntx * nty, tw * th, PAIR_CHUNK
    eps = consts["term_eps"]
    color = torch.zeros((nty * th, ntx * tw, 3), dtype=dtype, device=dev)
    trans = torch.ones((nty * th, ntx * tw), dtype=dtype, device=dev)
    grad = torch.zeros_like(feat) if dcolor is not None else None
    if dcolor is not None:
        dpad = torch.zeros((nty * th, ntx * tw, 3), dtype=dtype, device=dev)
        dpad[:height, :width] = dcolor.to(dtype)
    stats = {k: torch.zeros(T, dtype=torch.long, device=dev)
             for k in ("pairs_needed", "pairs_read", "accepted")}
    fd = feat.detach()
    B = max(1, BLOCK_ELEMS // (P * C))
    for b0 in range(0, T, B):
        tiles = torch.arange(b0, min(b0 + B, T), device=dev)
        px, py, ix, iy, real = _tile_pixels(tiles, width, height, consts,
                                            dtype)
        lo, hi = start[tiles], start[tiles + 1]
        nb = tiles.numel()
        tcarry = torch.where(real, torch.ones_like(px), torch.zeros_like(px))
        ccarry = torch.zeros((nb, P, 3), dtype=dtype, device=dev)
        done = torch.zeros(nb, dtype=torch.bool, device=dev)
        steps = int(((hi - lo + C - 1) // C).max().item()) if nb else 0
        grads_in = []
        for s in range(steps):
            live = ~done & (lo + s * C < hi)
            if not bool(live.any()):
                break
            li = torch.nonzero(live).squeeze(1)
            pos = lo[li, None] + s * C + torch.arange(C, device=dev)[None]
            valid = pos < hi[li, None]
            sp = splat[torch.where(valid, pos, torch.zeros_like(pos))]
            if dcolor is not None:
                # each chunk's features are a leaf of the block's graph,
                # so its backward gives per-pair gradients
                f = fd[sp].clone().requires_grad_(True)
                grads_in.append((f, sp, valid))
            else:
                f = fd[sp]
            alpha, accept = _chunk(f, valid, px[li], py[li], consts)
            t_in = tcarry[li]
            tinc = torch.cumprod(1.0 - alpha, -1) * t_in[:, :, None]
            texc = torch.cat([t_in[:, :, None], tinc[:, :, :-1]], -1)
            w = alpha * texc
            rgb = f[:, :, 6:9]
            add = (w[:, :, :, None] * rgb[:, None, :, :]).sum(2)
            ccarry = ccarry.index_add(0, li, add)
            tcarry = tcarry.index_copy(0, li, tinc[:, :, -1])
            tmax = tinc.amax(1)                       # [b, C]
            sat = tmax <= eps
            now_done = sat[:, -1] | ~valid[:, -1]
            if count:
                acc_real = accept & real[li][:, :, None]
                first = torch.where(sat.any(1), sat.int().argmax(1),
                                    valid.sum(1) - 1)
                upto = torch.arange(C, device=dev)[None] <= first[:, None]
                upto &= valid
                need = upto.sum(1)
                read = (acc_real.any(1) & upto).sum(1)
                acc = (acc_real & upto[:, None, :]).sum((1, 2))
                still = ~done[li]
                t_ids = tiles[li]
                stats["pairs_needed"].index_add_(0, t_ids, need * still)
                stats["pairs_read"].index_add_(0, t_ids, read * still)
                stats["accepted"].index_add_(0, t_ids, acc * still)
            done = done.index_copy(0, li, done[li] | now_done)
        if dcolor is not None and grads_in:
            yy = iy.clamp_max(nty * th - 1)
            xx = ix.clamp_max(ntx * tw - 1)
            dblock = dpad[yy, xx] * real[:, :, None]
            gs = torch.autograd.grad(ccarry, [g[0] for g in grads_in],
                                     grad_outputs=dblock, allow_unused=True)
            for (f, sp, valid), gf in zip(grads_in, gs):
                if gf is not None:
                    grad.index_add_(0, sp[valid], gf[valid])
        ccarry = ccarry.detach()
        color[iy, ix] = ccarry
        trans[iy, ix] = tcarry.detach()
    out = dict(color=color[:height, :width], trans=trans[:height, :width])
    if count:
        out.update(stats)
    if grad is not None:
        out["grad"] = grad
    return out


def render(cloud, cov6, view, *, dtype=torch.float32, consts=CONSTS,
           count: bool = False):
    """The reference frame of `view`: color [H, W, 3], trans [H, W] (and
    the per-tile counts with `count`). cloud is a scene.Cloud."""
    with torch.no_grad():
        p = project(cloud.means, cov6, cloud.opacity, cloud.sh, view,
                    dtype=dtype, consts=consts)
        start, splat = bin_pairs(p, view.width, view.height, consts)
        return composite(features(p), start, splat, view.width,
                         view.height, consts=consts, count=count)
