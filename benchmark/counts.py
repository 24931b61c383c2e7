"""Frozen copy of the port's rect-span pair count (`count_pairs` /
`_spans_numpy` of `gsrt_torch.models.gaussian_rt`), on the device: the
(tile, splat) pairs a view has before any cull. It sizes buffers in
set-up and is the base of `serve.pairs_kept_pct`."""

from __future__ import annotations

import math

import torch

from benchmark.reference import splats


def rect_pairs(c, cov6, view, consts=splats.CONSTS) -> int:
    """Pairs of `view` under the port's rect spans (no padding)."""
    with torch.no_grad():
        p = splats.project(c.means, cov6, c.opacity, c.sh, view,
                           consts=consts, sh_degree=0)
        qa, qb, qc = p["qa"], p["qb"], p["qc"]
        qdet = torch.clamp_min(qa * qc - qb * qb, 1e-18)
        g = torch.clamp_min(torch.log(torch.clamp_min(
            p["op"] / consts["alpha_threshold"], 1e-6)), 0.0)
        g = torch.clamp_max(g, consts["g_cutoff"])
        rx = torch.sqrt(torch.clamp_min(2.0 * g * qc / qdet, 0.0))
        ry = torch.sqrt(torch.clamp_min(2.0 * g * qa / qdet, 0.0))
        tw, th = consts["tile_w"], consts["tile_h"]
        W, H = view.width, view.height
        ntx, nty = math.ceil(W / tw), math.ceil(H / th)
        mx, my = p["mx"], p["my"]
        x0 = torch.clamp(torch.floor((mx - rx) / tw), 0, ntx - 1)
        x1 = torch.clamp(torch.floor((mx + rx) / tw), 0, ntx - 1)
        y0 = torch.clamp(torch.floor((my - ry) / th), 0, nty - 1)
        y1 = torch.clamp(torch.floor((my + ry) / th), 0, nty - 1)
        on = ((mx + rx >= 0) & (mx - rx < W) & (my + ry >= 0)
              & (my - ry < H))
        alive = p["alive"] & on & (rx > 0) & (ry > 0)
        n = torch.where(alive, (x1 - x0 + 1) * (y1 - y0 + 1),
                        torch.zeros_like(x0))
        return int(n.sum(dtype=torch.float64).item())


def pair_bucket(need: int) -> int:
    """Frozen copy of the port's `pair_bucket`: a (k/8)·2^j bucket, then
    a multiple of 128."""
    need = max(1 << 14, need)
    p = 1 << (need - 1).bit_length()
    step = max(p // 8, 128)
    mp = -(-need // step) * step
    return -(-mp // 128) * 128
