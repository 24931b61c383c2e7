"""Front-to-back EWA blend of the group-contiguous compact pair stream.

Counterpart of `gsrt.ops.splat_packed.blend_packed` in the mode the main
path runs (group_stream=True, compact payload). On a CUDA tensor it
launches `csrc/splat_packed.cu` (which replaces the TPU kernel
`_blend_packed_kernel`); on a CPU tensor it runs `blend_packed_plain`, a
per-tile loop of tensor code computing the same function.

Semantics, shared by both: each tile walks its pairs in payload order
(the per-tile depth order), with alpha = min(op·exp(−g), alpha_clamp),
g = t1² + t2² from the bf16 Cholesky factors (the response's ½ folded in),
accepted when alpha > alpha_threshold (and g ≤ g_cutoff unless
skip_range_check). The group's pair range is read in batches of
tile_w·tile_h columns starting at the group's first pair; before each
batch the tile stops if no pixel of it has trans > term_eps.
"""

from __future__ import annotations

import torch

from gsrt_torch import _kernels
from gsrt_torch.ops.tile_binning import (COMPACT_WIDTH, TileBinning,
                                         tile_extent, unpack_bf16_hi,
                                         unpack_bf16_lo, unpack_mean_rel,
                                         unpack_rgba8)

_RH = 0.7071067811865476   # sqrt(1/2): folds the response's ½ into t1, t2


def _check(binning: TileBinning, T: int) -> None:
    pay, ts = binning.payload, binning.tile_start
    if pay.dtype != torch.int32 or ts.dtype != torch.int32:
        raise TypeError("payload and tile_start must be int32")
    if pay.dim() != 2 or pay.shape[0] != COMPACT_WIDTH:
        raise ValueError(f"payload must be [{COMPACT_WIDTH}, L], got "
                         f"{tuple(pay.shape)}")
    if ts.shape != (T + 1,):
        raise ValueError(f"tile_start must be [{T + 1}], got "
                         f"{tuple(ts.shape)}")
    if pay.device != ts.device:
        raise ValueError("payload and tile_start must share a device")
    if not (pay.is_contiguous() and ts.is_contiguous()):
        raise ValueError("payload and tile_start must be contiguous")


def decode_pairs(cols: torch.Tensor) -> dict:
    """Decode compact payload columns [5, n] into float32 fields: the
    tile-relative mean, the Cholesky factors with ½ folded in, colors and
    opacity."""
    mx, my = unpack_mean_rel(cols[0])
    r, g, b, op = unpack_rgba8(cols[3])
    return dict(mx=mx, my=my,
                l11=unpack_bf16_hi(cols[1]) * _RH,
                l21=unpack_bf16_lo(cols[1]) * _RH,
                l22=unpack_bf16_hi(cols[2]) * _RH,
                rgb=torch.stack([r, g, b], -1), op=op)


def _blend_tile(f: dict, batch: torch.Tensor, px, py, *, g_cutoff,
                skip_range_check, alpha_threshold, alpha_clamp, term_eps):
    """One tile: f holds the decoded fields of its n pairs in order, batch
    [n] each pair's batch index. Returns (color [P, 3], trans [P], the
    number of pairs blended before the early stop)."""
    dx = px[:, None] - f["mx"][None, :]
    dy = py[:, None] - f["my"][None, :]
    t1 = f["l11"][None, :] * dx + f["l21"][None, :] * dy
    t2 = f["l22"][None, :] * dy
    gq = t1 * t1 + t2 * t2
    alpha = torch.clamp_max(f["op"][None, :] * torch.exp(-gq), alpha_clamp)
    accept = alpha > alpha_threshold
    if not skip_range_check:
        accept &= gq <= g_cutoff
    alpha = torch.where(accept, alpha, torch.zeros_like(alpha))
    incl = torch.cumprod(1.0 - alpha, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    # trans at the start of each pair's batch, from the batch's first pair
    first = torch.searchsorted(batch, batch)
    live = (excl[:, first] > term_eps).any(dim=0)      # a prefix of pairs
    n_live = int(live.sum())
    if n_live == 0:
        return torch.zeros((px.shape[0], 3), device=px.device), \
            torch.ones_like(px), 0
    w = (alpha * excl)[:, :n_live]
    return w @ f["rgb"][:n_live], incl[:, n_live - 1], n_live


def blend_packed_plain(binning: TileBinning, *, width: int, height: int,
                       sub_w: int, sub_h: int, bs: int,
                       g_cutoff: float = 5.6,
                       alpha_threshold: float = 1.0 / 255.0,
                       alpha_clamp: float = 0.99, term_eps: float = 1e-4,
                       skip_range_check: bool = False,
                       stats: dict | None = None):
    """Plain version of the group-stream blend: (color [H, W, 3],
    trans [H, W]) float32. A `stats` dict receives "pairs_blended", the
    pairs all tiles blend before their early stop (the data-dependent
    work a roofline bound counts)."""
    ntx, nty = tile_extent(width, height, sub_w, sub_h)
    T = ntx * nty
    dev = binning.payload.device
    npx = sub_w * sub_h
    pidx = torch.arange(npx, device=dev)
    px = (pidx % sub_w).to(torch.float32)
    py = (pidx // sub_w).to(torch.float32)
    color = torch.zeros((nty * sub_h, ntx * sub_w, 3), device=dev)
    trans = torch.ones((nty * sub_h, ntx * sub_w), device=dev)
    ts = binning.tile_start.tolist()
    pay = binning.payload
    blended = 0
    for g0 in range(0, T, bs):
        start, end = ts[g0], ts[min(g0 + bs, T)]
        if end <= start:
            continue
        tiles = pay[4, start:end]
        # stable sort by tile id: per-tile lists in payload order
        tsort, order = torch.sort(tiles, stable=True)
        f_all = decode_pairs(pay[:, start:end][:, order])
        batch_all = order // npx
        bounds = torch.searchsorted(
            tsort, torch.arange(g0, min(g0 + bs, T) + 1, device=dev,
                                dtype=tsort.dtype)).tolist()
        for j, tile in enumerate(range(g0, min(g0 + bs, T))):
            lo, hi = bounds[j], bounds[j + 1]
            if hi <= lo:
                continue
            f = {k: v[lo:hi] for k, v in f_all.items()}
            c, t, n_live = _blend_tile(
                f, batch_all[lo:hi].contiguous(), px, py, g_cutoff=g_cutoff,
                skip_range_check=skip_range_check,
                alpha_threshold=alpha_threshold, alpha_clamp=alpha_clamp,
                term_eps=term_eps)
            blended += n_live
            ty, tx = divmod(tile, ntx)
            ys, xs = ty * sub_h, tx * sub_w
            color[ys:ys + sub_h, xs:xs + sub_w] = c.reshape(sub_h, sub_w, 3)
            trans[ys:ys + sub_h, xs:xs + sub_w] = t.reshape(sub_h, sub_w)
    if stats is not None:
        stats["pairs_blended"] = blended
    return color[:height, :width].contiguous(), \
        trans[:height, :width].contiguous()


def blend_packed(binning: TileBinning, *, width: int, height: int,
                 sub_w: int = 32, sub_h: int = 16, bs: int = 120,
                 g_cutoff: float = 5.6,
                 alpha_threshold: float = 1.0 / 255.0,
                 alpha_clamp: float = 0.99, term_eps: float = 1e-4,
                 skip_range_check: bool = False, use_exp_lut: bool = False,
                 group_stream: bool = True):
    """Blend the group-contiguous compact stream: (color [H, W, 3],
    trans [H, W]) float32. bs is the group size in tiles (k full tile
    rows). The JAX kernel's LUT and tile-stream modes are not ported and
    raise."""
    if use_exp_lut or not group_stream:
        raise NotImplementedError(
            "gsrt_torch.blend_packed runs the group stream with exact exp "
            "only; the LUT and tile-stream modes are ROADMAP.md Queue 2 "
            "item 3")
    ntx, nty = tile_extent(width, height, sub_w, sub_h)
    T = ntx * nty
    _check(binning, T)
    npx = sub_w * sub_h
    if npx % 32 != 0 or npx > 1024:
        raise ValueError("tile_w * tile_h must be a multiple of 32, <= 1024")
    if bs % ntx != 0:
        raise ValueError("a group must be whole tile rows (bs % ntx == 0)")
    kw = dict(g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
              alpha_clamp=alpha_clamp, term_eps=term_eps,
              skip_range_check=skip_range_check)
    pay = binning.payload
    if not pay.is_cuda:
        return blend_packed_plain(binning, width=width, height=height,
                                  sub_w=sub_w, sub_h=sub_h, bs=bs, **kw)
    color = torch.empty((height, width, 3), dtype=torch.float32,
                        device=pay.device)
    trans = torch.empty((height, width), dtype=torch.float32,
                        device=pay.device)
    with torch.cuda.device(pay.device):
        _kernels.BLEND_GROUP(
            pay.data_ptr(), pay.shape[1], binning.tile_start.data_ptr(), T,
            ntx, bs, width, height, sub_w, sub_h, g_cutoff,
            int(skip_range_check), alpha_threshold, alpha_clamp, term_eps,
            color.data_ptr(), trans.data_ptr(), _kernels.stream_ptr(pay))
    return color, trans

