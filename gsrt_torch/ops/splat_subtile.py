"""Front-to-back f32 blend of the tile-sorted pair stream.

Counterpart of `gsrt.ops.splat_subtile.blend_subtiles`: the forward of
the training path and of `blend_impl="subtile"`. On a CUDA tensor it
launches `csrc/splat_subtile.cu` (which replaces the TPU kernel
`_blend_subtile_kernel`); on a CPU tensor it runs `blend_subtiles_plain`,
a per-tile loop of tensor code computing the same function.

Semantics, shared by both: each tile walks its own contiguous segment
[tile_start[t], tile_start[t + 1]) of the f32 payload in order (the per-tile
depth order), with g = ½(a·dx² + 2b·dx·dy + c·dy²) at integer pixel
coordinates, alpha = min(op·e(g), alpha_clamp), with e the exact exp(−g) or,
under use_exp_lut, the reference's 256-segment LUT, accepted when alpha >
alpha_threshold (and 0 ≤ g ≤ g_cutoff unless skip_range_check); colour and
opacity decode from the pack15 words. The segment is read in chunks of `chunk`
pairs; before each chunk the tile stops if no pixel of it (padding pixels past
the image edge included) has trans > term_eps. `blend_backward` takes the same
stop, so both agree on the last pair that counts.

Warp cull (kernels only; it changes no output). A CUDA thread holds a few
pixels of one tile column on consecutive rows (PIXELS_PER_THREAD here for
the forward, `splat_grad.PIXELS_PER_THREAD` for the backward), and a warp of
32 threads covers the rows and columns `warp_footprint` gives. Before a
warp runs a pair it tests a lower bound of the pair's response over those
rows and over those columns (`warp_cull`) against the response above which
the accept rule takes the pair nowhere (`splat_packed.skip_bound`), and
skips the pair when the bound exceeds it. The plain version counts the
(warp, pair) steps the cull removes in `stats`.
"""

from __future__ import annotations

import torch

from gsrt_torch import _kernels
from gsrt_torch.ops import explut
from gsrt_torch.ops.splat_packed import conic_row_factor, skip_bound
from gsrt_torch.ops.splat_packed import decode_f32_pairs as decode_pairs
from gsrt_torch.ops.tile_binning import PAYLOAD_WIDTH, TileBinning, tile_extent

KERNEL_CHUNK = 128      # pairs between two stop tests of the CUDA kernels
PIXELS_PER_THREAD = 4   # pixels of one column a thread of the forward holds


def check_stream(payload: torch.Tensor, tile_start: torch.Tensor, T: int,
                 tile_w: int, tile_h: int, chunk: int) -> None:
    """Validate what the subtile forward and backward kernels take."""
    if payload.dtype != torch.int32 or tile_start.dtype != torch.int32:
        raise TypeError("payload and tile_start must be int32")
    if payload.dim() != 2 or payload.shape[0] != PAYLOAD_WIDTH:
        raise ValueError(f"payload must be [{PAYLOAD_WIDTH}, max_pairs], "
                         f"got {tuple(payload.shape)}")
    if tile_start.shape != (T + 1,):
        raise ValueError(f"tile_start must be [{T + 1}], got "
                         f"{tuple(tile_start.shape)}")
    if payload.device != tile_start.device:
        raise ValueError("payload and tile_start must share a device")
    if not (payload.is_contiguous() and tile_start.is_contiguous()):
        raise ValueError("payload and tile_start must be contiguous")
    npx = tile_w * tile_h
    if npx % 32 != 0 or npx > 1024:
        raise ValueError("tile_w * tile_h must be a multiple of 32, <= 1024")
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    if payload.is_cuda and chunk != KERNEL_CHUNK:
        raise ValueError(f"the CUDA kernels take chunk={KERNEL_CHUNK}, the "
                         f"pairs between two of their stop tests; got "
                         f"{chunk}")


def block_threads(tile_w: int, tile_h: int, pix: int) -> int:
    """Threads of a CUDA block of one tile: `pix` rows a thread, whole
    warps (rows past the tile are dead)."""
    return -(-tile_w * -(-tile_h // pix) // 32) * 32


def warp_footprint(tile_w: int, tile_h: int, pix: int, device) -> tuple:
    """(first row, last row, first column, last column) [warps] float32,
    tile-relative, of the pixels each warp of a CUDA kernel holds: thread t
    has column t % tile_w and rows (t // tile_w)·pix + [0, pix); a warp
    that wraps a row spans every column."""
    t0 = 32 * torch.arange(block_threads(tile_w, tile_h, pix) // 32,
                           device=device)
    ra = torch.clamp_max((t0 // tile_w) * pix, tile_h - 1)
    rb = torch.clamp_max(((t0 + 31) // tile_w) * pix + pix - 1, tile_h - 1)
    c0 = t0 % tile_w
    wraps = c0 + 31 >= tile_w
    ca = torch.where(wraps, torch.zeros_like(c0), c0)
    cb = torch.where(wraps, torch.full_like(c0, tile_w - 1), c0 + 31)
    return tuple(v.float() for v in (ra, rb, ca, cb))


def warp_of_pixel(tile_w: int, tile_h: int, pix: int,
                  device) -> torch.Tensor:
    """[tile_w·tile_h] int64: the warp of a CUDA kernel with `pix` pixels a
    thread that holds each pixel of a tile (row-major)."""
    pidx = torch.arange(tile_w * tile_h, device=device)
    row, col = pidx // tile_w, pidx % tile_w
    return ((row // pix) * tile_w + col) // 32


def warp_cull(f: dict, foot: tuple, gs: torch.Tensor, ox=0.0, oy=0.0
              ) -> torch.Tensor:
    """[warps, n] bool: the (warp, pair) steps the CUDA kernels skip. lb =
    max(fl(qr·fl(dy²)), fl(qc·fl(dx²))) at the warp's row and column
    nearest the mean, qr = conic_row_factor(a, b, c) and qc =
    conic_row_factor(c, b, a) (each bounds the f32 response from below over
    every column, or every row); a step is skipped when lb > gs. ox, oy
    shift the footprint into the image frame: numbers, or [n], one a
    pair."""
    ra, rb, ca, cb = (v[:, None] for v in foot)
    my, mx = f["my"][None, :], f["mx"][None, :]
    dy = torch.clamp(my, ra + oy, rb + oy) - my
    dx = torch.clamp(mx, ca + ox, cb + ox) - mx
    qr = conic_row_factor(f["qa"], f["qb"], f["qc"])[None, :]
    qc = conic_row_factor(f["qc"], f["qb"], f["qa"])[None, :]
    lb = torch.fmax(qr * (dy * dy), qc * (dx * dx))
    return lb > gs[None, :]


def culled_steps(f: dict, foot: tuple, tile: int, ntx: int, tile_w: int,
                 tile_h: int, n_live: int, **rule) -> int:
    """The (warp, pair) steps `warp_cull` skips among a tile's first
    n_live pairs (f: their decoded fields); rule: skip_bound's keywords."""
    ty, tx = divmod(tile, ntx)
    cull = warp_cull(f, foot, skip_bound(f["op"], **rule),
                     float(tx * tile_w), float(ty * tile_h))
    return int(cull[:, :n_live].sum())


def tile_pixels(tile: int, ntx: int, tile_w: int, tile_h: int, device):
    """Pixel coordinates (x [P], y [P]) of a tile, row-major."""
    pidx = torch.arange(tile_w * tile_h, device=device)
    ty, tx = divmod(tile, ntx)
    return ((pidx % tile_w + tx * tile_w).to(torch.float32),
            (pidx // tile_w + ty * tile_h).to(torch.float32))


def pair_alphas(f: dict, px, py, *, g_cutoff, alpha_threshold,
                skip_range_check, use_exp_lut: bool = False,
                floor_g: bool = False):
    """[P, n] fields of a tile's pixels × pairs: dx, dy, e(g), its
    derivative e'(g), the unclamped op·e(g) and accept; e is exp(−g) or
    the LUT. The forward exponentiates g as it is (skip_range_check) or
    zeroed outside [0, g_cutoff]; the backward (`floor_g`) floors it at 0.
    The three agree wherever a pair is accepted and g ≥ 0."""
    dx = px[:, None] - f["mx"][None, :]
    dy = py[:, None] - f["my"][None, :]
    gq = 0.5 * (f["qa"] * dx * dx + 2.0 * f["qb"] * dx * dy
                + f["qc"] * dy * dy)
    in_range = (gq >= 0.0) & (gq <= g_cutoff)
    if floor_g:
        ge = torch.clamp_min(gq, 0.0)
    elif skip_range_check:
        ge = gq
    else:
        ge = torch.where(in_range, gq, torch.zeros_like(gq))
    if use_exp_lut:
        expg = explut.exp_neg_lut(ge)
        dexp = -torch.exp(-explut.lut_x0(ge))   # the segment's slope
    else:
        expg = torch.exp(-ge)
        dexp = -expg
    raw = f["op"][None, :] * expg
    accept = raw > alpha_threshold
    if not skip_range_check:
        accept = accept & in_range
    return dx, dy, expg, dexp, raw, accept


def live_pairs(excl: torch.Tensor, chunk: int, term_eps: float) -> int:
    """Pairs a tile blends before its stop: whole chunks, while some pixel
    has trans > term_eps at the chunk's first pair. excl is [P, n], the
    transmittance in front of each pair."""
    starts = excl[:, ::chunk]                              # [P, n_chunks]
    live_chunks = int((starts > term_eps).any(dim=0).sum())
    return min(live_chunks * chunk, excl.shape[1])


def blend_subtiles_plain(binning: TileBinning, *, width: int, height: int,
                         sub_w: int = 16, sub_h: int = 16, chunk: int = 128,
                         g_cutoff: float = 5.6,
                         alpha_threshold: float = 1.0 / 255.0,
                         alpha_clamp: float = 0.99, term_eps: float = 1e-4,
                         skip_range_check: bool = False,
                         use_exp_lut: bool = False,
                         stats: dict | None = None):
    """Plain version of the subtile blend: (color [H, W, 3], trans [H, W])
    float32. A `stats` dict receives "pairs_blended", the pairs all tiles
    blend before their stop, "accepted", the (pixel, pair) products among
    them whose alpha was blended (the data-dependent work a roofline bound
    counts), "warp_steps", the pairs blended times the CUDA kernel's warps
    a tile, and "culled_steps", the (warp, pair) steps of them its warp
    cull skips."""
    ntx, nty = tile_extent(width, height, sub_w, sub_h)
    T = ntx * nty
    pay = binning.payload
    dev = pay.device
    color = torch.zeros((nty * sub_h, ntx * sub_w, 3), device=dev)
    trans = torch.ones((nty * sub_h, ntx * sub_w), device=dev)
    ts = binning.tile_start.tolist()
    rule = dict(g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
                skip_range_check=skip_range_check, use_exp_lut=use_exp_lut)
    foot = warp_footprint(sub_w, sub_h, PIXELS_PER_THREAD, dev)
    blended = accepted = culled = 0
    for tile in range(T):
        lo, hi = ts[tile], ts[tile + 1]
        if hi <= lo:
            continue
        f = decode_pairs(pay[:, lo:hi])
        px, py = tile_pixels(tile, ntx, sub_w, sub_h, dev)
        _, _, _, _, raw, accept = pair_alphas(
            f, px, py, g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
            skip_range_check=skip_range_check, use_exp_lut=use_exp_lut)
        alpha = torch.where(accept, torch.clamp_max(raw, alpha_clamp),
                            torch.zeros_like(raw))
        incl = torch.cumprod(1.0 - alpha, dim=1)
        excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
        n_live = live_pairs(excl, chunk, term_eps)   # >= 1: excl[:, 0] = 1
        blended += n_live
        if stats is not None:
            accepted += int(accept[:, :n_live].sum())
            culled += culled_steps(f, foot, tile, ntx, sub_w, sub_h, n_live,
                                   **rule)
        w = (alpha * excl)[:, :n_live]
        ty, tx = divmod(tile, ntx)
        ys, xs = ty * sub_h, tx * sub_w
        color[ys:ys + sub_h, xs:xs + sub_w] = \
            (w @ f["rgb"][:n_live]).reshape(sub_h, sub_w, 3)
        trans[ys:ys + sub_h, xs:xs + sub_w] = \
            incl[:, n_live - 1].reshape(sub_h, sub_w)
    if stats is not None:
        stats.update(pairs_blended=blended, accepted=accepted,
                     warp_steps=blended * foot[0].numel(),
                     culled_steps=culled)
    return color[:height, :width].contiguous(), \
        trans[:height, :width].contiguous()


def blend_subtiles(binning: TileBinning, *, width: int, height: int,
                   sub_w: int = 16, sub_h: int = 16, chunk: int = 128,
                   g_cutoff: float = 5.6,
                   alpha_threshold: float = 1.0 / 255.0,
                   alpha_clamp: float = 0.99, term_eps: float = 1e-4,
                   skip_range_check: bool = False,
                   use_exp_lut: bool = False, kernel=None):
    """Blend the f32 tile stream: (color [H, W, 3], trans [H, W]) float32.
    `binning` must have been built with compact=False and tile_w=sub_w,
    tile_h=sub_h. `kernel` is the launch counter the CUDA launch goes to
    (the subtile blend's own unless a caller names another)."""
    ntx, nty = tile_extent(width, height, sub_w, sub_h)
    T = ntx * nty
    pay, ts = binning.payload, binning.tile_start
    check_stream(pay, ts, T, sub_w, sub_h, chunk)
    kw = dict(g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
              alpha_clamp=alpha_clamp, term_eps=term_eps,
              skip_range_check=skip_range_check, use_exp_lut=use_exp_lut)
    if not pay.is_cuda:
        return blend_subtiles_plain(binning, width=width, height=height,
                                    sub_w=sub_w, sub_h=sub_h, chunk=chunk,
                                    **kw)
    color = torch.empty((height, width, 3), dtype=torch.float32,
                        device=pay.device)
    trans = torch.empty((height, width), dtype=torch.float32,
                        device=pay.device)
    with torch.cuda.device(pay.device):
        (kernel or _kernels.BLEND_SUBTILE)(
            pay.data_ptr(), pay.shape[1], ts.data_ptr(), T, ntx, width,
            height, sub_w, sub_h, chunk, PIXELS_PER_THREAD, g_cutoff,
            int(skip_range_check), alpha_threshold, alpha_clamp, term_eps,
            int(use_exp_lut),
            color.data_ptr(), trans.data_ptr(), _kernels.stream_ptr(pay))
    return color, trans
