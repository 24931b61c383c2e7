"""Screen-tile binning of projected splats, in three streams and two
span modes.

Counterpart of `gsrt.ops.tile_binning`.

* The group-contiguous compact stream (`compact=True, stream="group"`),
  the path `render_tiled` takes at its defaults. Splats are depth-sorted
  once; each expands to (splat × row-group) units, where a group is k full
  tile rows (bs = k·ntx tiles); one stable sort of the units by group id
  makes the pairs contiguous per group and depth-ordered per tile; the
  emit expansion then writes the compact payload directly.
* The tile-sorted compact stream (`compact=True, stream="tile"`), which
  serving and the packed blend's tile mode read. Depth-sorted splats
  expand to pairs (copy mode, or the emit mode with
  `expand_impl="binned"`), and one stable sort by tile id makes each
  tile's pairs one contiguous, depth-ordered segment of the compact
  payload.
* The tile-sorted f32 stream (`compact=False`), which training, the
  subtile blend and the (128, 8)-tile blend read. As the compact tile
  stream, but the payload carries the f32 features unrounded. With
  `with_ids` it also carries each pair's depth-order index and the
  per-splat bookkeeping that routes pair gradients back to splats.

Ellipse spans (`span_mode="ellipse"`, both tile streams): a splat pairs
only with the tiles its ellipse reaches, not every tile of its bounding
box. Depth-sorted splats expand to tile-row units (level 1, the copy
expand); each row takes the exact x-interval of the ellipse over its
pixel rows; the rows then go through the tile stream's second half as
w_span × 1 units (level 2). Only pairs that no pixel takes in f32 are
gone, so the f32 payload renders the rect spans' image; on the compact
payload the rounded conic and opacity can let a dropped pair clear the
alpha threshold, by about alpha_threshold times its colour.

Serving adds two hooks: `cutoff_map` culls, before the histogram, the
splats that lie behind the previous frame's saturation depth in every
tile they touch (`cutoff_cull`), and `carry_depth` returns each sorted
pair's camera depth in `TileBinning.pair_depth`.

The data contract is the JAX package's: the same pairs, the same per-tile
depth order, the same fields, the same tile_start / tile_count /
total_pairs / overflow / pair_depth.

Sorts are `torch.sort` plus index gathers and the tile histogram is a
scatter-add of rectangle corner marks followed by two prefix sums: none of
this is a TPU kernel. On CUDA tensors the group stream is built instead by
`ops.tile_bin` (three launches of `csrc/tile_bin.cu` around the depth sort
and the two expands), bit for bit the stream of the plain version here,
which CPU tensors take. Payloads keep their live rows and columns only: the
JAX package pads the compact payload to eight rows and both payloads by a
chunk + 128 column tail for the TPU's DMA windows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# --- compact payload: int32 [5, max_pairs] ---
# rows: 0 mean (2 x u16 fixed point, TILE-relative, two-tier per axis)
#       1 chol.l11 | chol.l21 (2 x bf16)   2 chol.l22 | camera depth (bf16)
#       3 rgba8888 (two-tier 8-bit color x3 + u8 opacity)   4 tile id
COMPACT_WIDTH = 5
MEAN_FINE_SCALE = 256.0    # 1/256 px quantization …
MEAN_FINE_BIAS = 64.0      # … over [-64, +64) px
MEAN_COARSE_SCALE = 8.0    # 1/8 px quantization …
MEAN_COARSE_BIAS = 2048.0  # … over [-2048, +2048) px (saturating)
# 8-bit two-tier color channel: bit 7 = 0 → value = mag/127 over [0, 1];
# bit 7 = 1 → value = 1 + mag·3/127 over (1, 4]. Opacity is u8/255.
COLOR8_FINE = 1.0 / 127.0
COLOR8_COARSE = 3.0 / 127.0

# --- f32 payload: int32 [8, max_pairs], float rows travel as their bits ---
# rows: 0 mean x, 1 mean y, 2-4 conic a, b, c (all f32 bits),
#       5 pack15(r, g), 6 pack15(b, opacity),
#       7 depth-order pair index (with_ids; max_pairs on dead slots), else
#         tile id | bit 30
PAYLOAD_WIDTH = 8
N_FEATURES = 7
PACK_RANGE = 4.0           # pack15 covers [0, PACK_RANGE) in 15 bits
_PACK_BIAS = 1 << 30

SUPER = 8   # tiles per supertile side for the cutoff coarsening


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _pack_color8(c: torch.Tensor) -> torch.Tensor:
    fine = _i32(torch.clamp(torch.round(c * 127.0), 0, 127))
    coarse = _i32(torch.clamp(torch.round((c - 1.0) * (127.0 / 3.0)),
                              0, 127)) | 0x80
    return torch.where(c <= 1.0, fine, coarse)


def pack_rgba8(r, g, b, o) -> torch.Tensor:
    """Three two-tier 8-bit colors + u8 opacity → one int32
    (r << 24 | g << 16 | b << 8 | o)."""
    oi = _i32(torch.clamp(torch.round(o * 255.0), 0, 255))
    return ((_pack_color8(r) << 24) | (_pack_color8(g) << 16)
            | (_pack_color8(b) << 8) | oi)


def unpack_rgba8(w: torch.Tensor):
    """int32 rgba8 word → (r, g, b, opacity) float32."""
    def color8(c8):
        mag = (c8 & 0x7F).to(torch.float32)
        return torch.where((c8 & 0x80) != 0, 1.0 + mag * COLOR8_COARSE,
                           mag * COLOR8_FINE)
    op = (w & 0xFF).to(torch.float32) * (1.0 / 255.0)
    return (color8((w >> 24) & 0xFF), color8((w >> 16) & 0xFF),
            color8((w >> 8) & 0xFF), op)


def pack15(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Two [0, PACK_RANGE) floats → one int32 word bit30 | (u15 << 15) | u15.
    The cast truncates, as the JAX package's does."""
    q = 32767.0 / PACK_RANGE
    xi = _i32(torch.clamp(x * q, 0, 32767))
    yi = _i32(torch.clamp(y * q, 0, 32767))
    return _PACK_BIAS | (xi << 15) | yi


def unpack15(w: torch.Tensor):
    """pack15 word → (hi, lo) float32."""
    inv_q = PACK_RANGE / 32767.0
    return (((w >> 15) & 0x7FFF).to(torch.float32) * inv_q,
            (w & 0x7FFF).to(torch.float32) * inv_q)


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even bf16 of x as an int32 in [0, 0xFFFF]."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def pack_bf16_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two f32 → one int32: bf16(hi) in the top 16 bits, bf16(lo) below."""
    return (_bf16_bits(hi) << 16) | _bf16_bits(lo)


def unpack_bf16_hi(w: torch.Tensor) -> torch.Tensor:
    return (w & -65536).view(torch.float32)


def unpack_bf16_lo(w: torch.Tensor) -> torch.Tensor:
    return (w << 16).view(torch.float32)


def _pack_mean_axis(v: torch.Tensor) -> torch.Tensor:
    """One tile-relative coordinate → u16: bit 15 = 0 fine (1/256 px,
    ±64 px), = 1 coarse (1/8 px, ±2048 px, saturating)."""
    fine = _i32(torch.clamp(torch.round((v + MEAN_FINE_BIAS)
                                        * MEAN_FINE_SCALE), 0, 32767))
    coarse = _i32(torch.clamp(torch.round((v + MEAN_COARSE_BIAS)
                                          * MEAN_COARSE_SCALE),
                              0, 32767)) | 0x8000
    return torch.where((v >= -MEAN_FINE_BIAS) & (v < MEAN_FINE_BIAS),
                       fine, coarse)


def pack_mean_rel(mx_rel: torch.Tensor, my_rel: torch.Tensor
                  ) -> torch.Tensor:
    """Tile-relative mean → (x u16 << 16) | y u16, each two-tier."""
    return (_pack_mean_axis(mx_rel) << 16) | _pack_mean_axis(my_rel)


def unpack_mean_rel(w: torch.Tensor):
    """Packed mean word → (mx_rel, my_rel) float32."""
    def axis(w16):
        mag = (w16 & 0x7FFF).to(torch.float32)
        return torch.where((w16 & 0x8000) != 0,
                           mag * (1.0 / MEAN_COARSE_SCALE) - MEAN_COARSE_BIAS,
                           mag * (1.0 / MEAN_FINE_SCALE) - MEAN_FINE_BIAS)
    return axis((w >> 16) & 0xFFFF), axis(w & 0xFFFF)


class TileBinning(NamedTuple):
    payload: torch.Tensor      # int32; compact: [5, max_pairs], contiguous
                               # per group, depth order per tile; f32:
                               # [8, max_pairs], (tile, depth)-ordered
    tile_start: torch.Tensor   # [T + 1] int32 pair offsets per tile
    tile_count: torch.Tensor   # [T] int32 pairs per tile
    total_pairs: torch.Tensor  # [] int32 pairs before capping
    overflow: torch.Tensor     # [] bool — pairs or units exceeded the buffers
    # set only by the f32 stream built with with_ids=True:
    sorted_base: torch.Tensor | None = None     # [N] int32 first pair of
                               # each depth-sorted splat (_DEAD_BASE if none)
    sorted_touched: torch.Tensor | None = None  # [N] int32 pairs per
                               # depth-sorted splat
    sorted_orig: torch.Tensor | None = None     # [N] int32 original index
                               # of each depth-sorted slot
    # set with carry_depth=True (serving):
    pair_depth: torch.Tensor | None = None      # [max_pairs] f32 camera
                               # depth of each payload column's splat
                               # (the bf16 half of qcd on the compact
                               # streams); defined on live columns


def conic_cholesky(qa, qb, qc):
    """(l11, l21, l22): the Cholesky factor of the conic [[a, b], [b, c]]
    that the compact payload carries (as bf16 pairs), floored at 1e-12."""
    l11 = torch.sqrt(torch.clamp_min(qa, 1e-12))
    l21 = qb / torch.clamp_min(l11, 1e-12)
    l22 = torch.sqrt(torch.clamp_min(qc - l21 * l21, 1e-12))
    return l11, l21, l22


def tile_extent(width: int, height: int, tile_w: int, tile_h: int):
    return -(-width // tile_w), -(-height // tile_h)


def compute_tile_spans(cx, cy, rx, ry, alive, width, height, tile_w, tile_h):
    """Inclusive tile spans of each splat's footprint bounding box.
    Returns (x0, x1, y0, y1, touched) int32; touched = 0 if culled."""
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    x0 = _i32(torch.clamp(torch.floor((cx - rx) / tile_w), 0, ntx - 1))
    x1 = _i32(torch.clamp(torch.floor((cx + rx) / tile_w), 0, ntx - 1))
    y0 = _i32(torch.clamp(torch.floor((cy - ry) / tile_h), 0, nty - 1))
    y1 = _i32(torch.clamp(torch.floor((cy + ry) / tile_h), 0, nty - 1))
    on_screen = ((cx + rx >= 0) & (cx - rx < width)
                 & (cy + ry >= 0) & (cy - ry < height))
    alive = alive & on_screen & (rx > 0) & (ry > 0)
    touched = torch.where(alive, (x1 - x0 + 1) * (y1 - y0 + 1),
                          torch.zeros_like(x0))
    return x0, x1, y0, y1, touched


def tile_histogram(x0, x1, y0, y1, alive, ntx: int, nty: int
                   ) -> torch.Tensor:
    """Per-tile pair counts [nty, ntx] from inclusive tile spans: +1/−1
    marks at the four corners of each rectangle, scatter-added into a
    (nty+1, ntx+1) grid, then prefix sums along both axes."""
    w = _i32(alive)
    row = ntx + 1
    marks = torch.zeros((nty + 1) * row, dtype=torch.int32,
                        device=x0.device)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1 + 1, -1),
                         (y1 + 1, x0, -1), (y1 + 1, x1 + 1, 1)):
        marks.index_add_(0, (ys * row + xs).long(), w * sign)
    grid = marks.view(nty + 1, row)
    grid = torch.cumsum(torch.cumsum(grid, 0, dtype=torch.int32), 1,
                        dtype=torch.int32)
    return grid[:nty, :ntx].contiguous()


def group_rows_k(ntx: int, bs_max: int = 128) -> int | None:
    """Rows of tiles per group for the group-contiguous stream: the largest
    k ≤ 31 with k·ntx ≤ bs_max and (k·ntx) % 8 == 0, or None. The group
    shape is the JAX package's, so both streams group pairs alike."""
    best = None
    for k in range(1, min(bs_max // max(ntx, 1), 31) + 1):
        if (k * ntx) % 8 == 0:
            best = k
    return best


def cutoff_cull(depth, x0, x1, y0, y1, cutoff_map, ntx: int, nty: int,
                super_size: int = SUPER) -> torch.Tensor:
    """Serving's depth cull: keep[s] when splat s's camera depth is within
    the previous frame's saturation cutoff of some tile its footprint
    touches, tested conservatively on a supertile max map.

    cutoff_map [nty·ntx] f32 holds, per tile, the depth behind which that
    tile saturated (+inf keeps everything). Tiles are coarsened to
    super_size² supertiles by their max (the padding past the grid counts
    as -inf), clipped to ±1e30 as the JAX package clips them for its
    matrix-product gather; each splat reads the four supertiles at the
    corners of its tile rectangle. A splat whose rectangle spans more than
    two supertiles along an axis, which the corners would under-cover, is
    kept. Returns keep [N] bool, a superset of the exact per-tile test."""
    s = super_size
    nsx, nsy = -(-ntx // s), -(-nty // s)
    cm = torch.nn.functional.pad(cutoff_map.reshape(nty, ntx),
                                 (0, nsx * s - ntx, 0, nsy * s - nty),
                                 value=float("-inf"))
    sm = cm.reshape(nsy, s, nsx, s).amax(dim=(1, 3)).reshape(-1)
    sm = torch.clamp(sm, -1e30, 1e30)
    sx0, sx1, sy0, sy1 = x0 // s, x1 // s, y0 // s, y1 // s
    big = (sx1 - sx0 > 1) | (sy1 - sy0 > 1)
    est = torch.maximum(
        torch.maximum(sm[(sy0 * nsx + sx0).long()],
                      sm[(sy0 * nsx + sx1).long()]),
        torch.maximum(sm[(sy1 * nsx + sx0).long()],
                      sm[(sy1 * nsx + sx1).long()]))
    return (depth <= est) | big


def build_tile_binning(
    depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb, rx, ry, alive,
    *, width: int, height: int, tile_w: int = 32, tile_h: int = 16,
    max_pairs: int = 1 << 20, compact: bool = True, span_mode: str = "rect",
    max_rows: int | None = None, stream: str = "group",
    expand_impl: str = "fused", with_ids: bool = False, cutoff_map=None,
    carry_depth: bool = False, cull_super: int = SUPER,
    g_cutoff: float = 5.6, alpha_threshold: float = 1.0 / 255.0,
) -> TileBinning:
    """Bin splats into per-tile depth-ordered pairs.

    Per-splat inputs are [N] columns and need not be depth-sorted.
    compact=True builds the compact payload, contiguous per group of k
    tile rows (stream="group") or per tile (stream="tile");
    compact=False the tile-sorted f32 stream. The tile streams expand
    with `expand_impl`: "fused" or "pallas" (the copy kernels), "binned"
    (the emit kernel on the compact stream; `expand_pairs`, the copy
    kernel under a launch count of its own, on the f32 stream, as in the
    JAX package), or "xla" (the plain version, CPU only). with_ids adds
    the gradient-routing bookkeeping (f32 stream); cutoff_map culls by
    serving's saturation depths (`cutoff_cull`, supertiles of cull_super
    tiles) before the histogram, so the counts describe the culled
    stream; carry_depth fills `pair_depth`. span_mode="ellipse" bins
    ellipse spans on the tile stream of either payload (stream is then
    ignored; at most 255 tile rows; max_rows sizes its tile-row buffer,
    max_pairs when None); it is forward only (with_ids raises)."""
    if span_mode not in ("rect", "ellipse"):
        raise ValueError(f"unknown span_mode {span_mode!r}")
    if stream not in ("group", "tile"):
        raise ValueError(f"unknown stream {stream!r}")
    ellipse = span_mode == "ellipse"
    group = compact and stream == "group" and not ellipse
    if with_ids and compact:
        raise ValueError("with_ids needs the f32 stream (compact=False)")
    if with_ids and ellipse:
        raise ValueError("ellipse spans are forward only: with_ids needs "
                         "rect spans")
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    T = ntx * nty
    k = group_rows_k(ntx)
    if compact and ntx > 127:
        raise ValueError("the compact payload packs the tile x-span in 7 "
                         f"bits: ntx={ntx} > 127")
    if ellipse and nty > 255:
        raise ValueError(f"ellipse spans take at most 255 tile rows: "
                         f"nty={nty}; use rect spans")
    if group and k is None:
        raise ValueError(f"tile grid ntx={ntx} has no group shape; use "
                         f"stream='tile'")
    if ntx >= (1 << 12) or nty >= (1 << 12) or T >= (1 << 20):
        raise ValueError("tile grid exceeds the packed-operand bit budget")

    if group:
        # CUDA tensors take the kernels, CPU tensors the plain version
        bin_group = _bin_group_cuda if depth.is_cuda else group_stream_plain
        return bin_group(
            depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb, rx, ry,
            alive, width=width, height=height, tile_w=tile_w, tile_h=tile_h,
            max_pairs=max_pairs,
            max_units=max_rows if max_rows is not None else max_pairs,
            cutoff_map=cutoff_map, cull_super=cull_super,
            carry_depth=carry_depth)
    x0, x1, y0, y1, touched = compute_tile_spans(
        m2x, m2y, rx, ry, alive, width, height, tile_w, tile_h)
    opacity = torch.where(alive, opacity, torch.zeros_like(opacity))
    if cutoff_map is not None:
        keep = cutoff_cull(depth, x0, x1, y0, y1, cutoff_map, ntx, nty,
                           super_size=cull_super)
        touched = torch.where(keep, touched, torch.zeros_like(touched))
    if ellipse:
        return _build_ellipse(
            depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb,
            x0, x1, y0, y1, touched, ntx=ntx, nty=nty, T=T, tile_w=tile_w,
            tile_h=tile_h, max_pairs=max_pairs,
            max_rows=max_rows if max_rows is not None else max_pairs,
            compact=compact, expand_impl=expand_impl,
            carry_depth=carry_depth, g_cutoff=g_cutoff,
            alpha_threshold=alpha_threshold)
    counts = tile_histogram(x0, x1, y0, y1, touched > 0, ntx, nty).reshape(T)
    total = touched.sum(dtype=torch.int32)
    overflow = total > max_pairs
    tile_start = torch.cat([torch.zeros(1, dtype=torch.int32,
                                        device=counts.device),
                            torch.cumsum(counts, 0, dtype=torch.int32)])
    # overflow truncates the deepest pairs; clamping keeps every segment
    # inside the payload until the caller re-calibrates
    tile_start = torch.minimum(tile_start, torch.clamp_max(total, max_pairs))
    bk = dict(counts=counts, tile_start=tile_start, total=total,
              overflow=overflow)
    if compact:
        return _build_compact_stream(
            depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb,
            x0, x1, y0, touched, ntx=ntx, T=T, tile_w=tile_w,
            tile_h=tile_h, max_pairs=max_pairs, expand_impl=expand_impl,
            carry_depth=carry_depth, **bk)
    return _build_f32_stream(
        depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb,
        x0, x1, y0, touched, ntx=ntx, T=T, max_pairs=max_pairs,
        expand_impl=expand_impl, with_ids=with_ids,
        carry_depth=carry_depth, **bk)


def _expand_copy(tab: torch.Tensor, base: torch.Tensor, max_pairs: int,
                 expand_impl: str) -> torch.Tensor:
    """The tile streams' splat → pair copy, by `expand_impl`."""
    from gsrt_torch.ops import pair_expand
    if expand_impl == "fused":
        return pair_expand.expand_pairs_fused(tab, base, max_pairs)
    if expand_impl in ("pallas", "binned"):
        return pair_expand.expand_pairs(tab, base, max_pairs)
    if expand_impl == "xla":
        if tab.is_cuda:
            raise ValueError(
                "expand_impl='xla' is the plain version and runs on CPU "
                "tensors only; on CUDA use 'fused', 'pallas' or 'binned'")
        return pair_expand.expand_pairs_plain(tab, base, max_pairs)
    raise ValueError(f"unknown expand_impl {expand_impl!r}")


def _depth_order(depth, touched):
    """Splats that emit pairs first, front to back: (order, touched in
    that order, each sorted splat's first pair or _DEAD_BASE)."""
    from gsrt_torch.ops.pair_expand import _DEAD_BASE
    key = torch.where(touched > 0, depth,
                      torch.full_like(depth, float("inf")))
    order = torch.argsort(key, stable=True)
    touched_s = touched[order]
    offsets = torch.cumsum(touched_s, 0, dtype=torch.int32)
    base = torch.where(touched_s > 0, offsets - touched_s,
                       torch.full_like(offsets, _DEAD_BASE))
    return order, touched_s, base


def _build_compact_stream(
    depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb, x0, x1, y0,
    touched, *, ntx, T, tile_w, tile_h, max_pairs, expand_impl,
    carry_depth, counts, tile_start, total, overflow,
) -> TileBinning:
    """Depth sort, then `_finish_compact` over the splats
    (`_build_compact` of the JAX package)."""
    order, _, base = _depth_order(depth, touched)
    w_span = torch.clamp_min(x1 - x0 + 1, 1)
    l11, l21, l22 = conic_cholesky(qa_c, qb_c, qc_c)
    tab = torch.stack([x0 | (y0 << 12) | (w_span << 24), x0,
                       m2x.view(torch.int32), m2y.view(torch.int32),
                       pack_bf16_pair(l11, l21), pack_bf16_pair(l22, depth),
                       pack_rgba8(cr, cg, cb, opacity)])[:, order]
    tab[1] = base
    return _finish_compact(
        tab, base, ntx=ntx, T=T, tile_w=tile_w, tile_h=tile_h,
        max_pairs=max_pairs, expand_impl=expand_impl,
        carry_depth=carry_depth, counts=counts, tile_start=tile_start,
        total=total, overflow=overflow)


def _finish_compact(
    tab, base, *, ntx, T, tile_w, tile_h, max_pairs, expand_impl,
    carry_depth, counts, tile_start, total, overflow,
) -> TileBinning:
    """Expand depth-ordered units → pairs, stable sort by tile id, compact
    payload [5, max_pairs]. A unit (a splat under rect spans, a tile row
    under ellipse spans) is a column of tab [7, U]: geometry
    x0 | y0 << 12 | w_span << 24, its first pair `base` (_DEAD_BASE if
    none), mean x and y bits, qab, qcd, rgba. With expand_impl="binned"
    the emit kernel writes the payload rows and only rgba is zeroed on
    dead columns; the copy expansions zero every feature row there, as in
    the JAX package."""
    from gsrt_torch.ops.pair_expand import expand_pairs_binned

    dev = tab.device
    live_total = torch.clamp_max(total, max_pairs)
    if expand_impl == "binned":
        rb = expand_pairs_binned(tab, base, max_pairs, total=live_total,
                                 ntx=ntx, T=T, tile_w=tile_w, tile_h=tile_h)
        tile_s, perm = torch.sort(rb[4], stable=True)
        feats = rb[:4, perm]
    else:
        e = _expand_copy(tab, base, max_pairs, expand_impl)
        gx0, gy0 = e[0] & 0xFFF, (e[0] >> 12) & 0xFFF
        gw = torch.clamp_min((e[0] >> 24) & 0x7F, 1)
        slots = torch.arange(max_pairs, dtype=torch.int32, device=dev)
        rank = slots - e[1]
        q = torch.div(rank, gw, rounding_mode="floor")
        tx, ty = gx0 + (rank - q * gw), gy0 + q
        tile = torch.where(slots < live_total, ty * ntx + tx,
                           torch.full_like(slots, T))
        mx_rel = e[2].view(torch.float32) - tx.to(torch.float32) * tile_w
        my_rel = e[3].view(torch.float32) - ty.to(torch.float32) * tile_h
        # a mean past the coarse tier's ±2048 px would decode clamped: the
        # JAX package drops such a pair (its response there is ~0)
        mean_sat = ((mx_rel.abs() >= MEAN_COARSE_BIAS - 0.5)
                    | (my_rel.abs() >= MEAN_COARSE_BIAS - 0.5))
        rgba = torch.where(mean_sat, torch.zeros_like(e[6]), e[6])
        feats = torch.stack([pack_mean_rel(mx_rel, my_rel), e[4], e[5],
                             rgba])
        tile_s, perm = torch.sort(tile, stable=True)
        feats = feats[:, perm]
        feats = torch.where((tile_s >= T)[None, :], torch.zeros_like(feats),
                            feats)
    payload = torch.cat([feats, torch.clamp_max(tile_s, T)[None, :]])
    return TileBinning(
        payload=payload, tile_start=tile_start, tile_count=counts,
        total_pairs=total, overflow=overflow,
        pair_depth=unpack_bf16_lo(feats[2]) if carry_depth else None)


def group_stream_plain(depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg,
                       cb, rx, ry, alive, *, width, height, tile_w, tile_h,
                       max_pairs, max_units, cutoff_map=None,
                       cull_super=SUPER, carry_depth=False) -> TileBinning:
    """`build_tile_binning`'s group stream as plain tensor ops: the spans,
    the histogram and `_build_group_stream_plain`. CPU tensors take it; on
    the card it is the reference `ops.tile_bin`'s kernels equal."""
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    T = ntx * nty
    x0, x1, y0, y1, touched = compute_tile_spans(
        m2x, m2y, rx, ry, alive, width, height, tile_w, tile_h)
    opacity = torch.where(alive, opacity, torch.zeros_like(opacity))
    if cutoff_map is not None:
        keep = cutoff_cull(depth, x0, x1, y0, y1, cutoff_map, ntx, nty,
                           super_size=cull_super)
        touched = torch.where(keep, touched, torch.zeros_like(touched))
    counts = tile_histogram(x0, x1, y0, y1, touched > 0, ntx, nty).reshape(T)
    total = touched.sum(dtype=torch.int32)
    tile_start = torch.cat([torch.zeros(1, dtype=torch.int32,
                                        device=counts.device),
                            torch.cumsum(counts, 0, dtype=torch.int32)])
    tile_start = torch.minimum(tile_start, torch.clamp_max(total, max_pairs))
    return _build_group_stream_plain(
        depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb,
        x0, x1, y0, y1, touched, ntx=ntx, nty=nty, T=T, tile_w=tile_w,
        tile_h=tile_h, max_pairs=max_pairs, max_units=max_units,
        k_rows=group_rows_k(ntx), carry_depth=carry_depth, counts=counts,
        tile_start=tile_start, total=total, overflow=total > max_pairs)


def _bin_group_cuda(depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb,
                    rx, ry, alive, *, width, height, tile_w, tile_h,
                    max_pairs, max_units, cutoff_map, cull_super,
                    carry_depth) -> TileBinning:
    """The group stream of CUDA columns through `ops.tile_bin`'s kernels,
    bit-equal to `group_stream_plain` on the card; serving's cull, where
    given, is computed here as in the plain route."""
    from gsrt_torch.ops.tile_bin import bin_group_stream
    keep = None
    if cutoff_map is not None:
        ntx, nty = tile_extent(width, height, tile_w, tile_h)
        x0, x1, y0, y1, _ = compute_tile_spans(
            m2x, m2y, rx, ry, alive, width, height, tile_w, tile_h)
        keep = cutoff_cull(depth, x0, x1, y0, y1, cutoff_map, ntx, nty,
                           super_size=cull_super).contiguous()
    cols = (depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb, rx, ry,
            alive)
    return bin_group_stream(
        *(c.contiguous() for c in cols), width=width, height=height,
        tile_w=tile_w, tile_h=tile_h, max_pairs=max_pairs,
        max_units=max_units, keep=keep, carry_depth=carry_depth)


def _build_group_stream_plain(
    depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb,
    x0, x1, y0, y1, touched, *, ntx, nty, T, tile_w, tile_h, max_pairs,
    max_units, k_rows, carry_depth, counts, tile_start, total, overflow,
) -> TileBinning:
    """Depth sort, level-1 expand (splats → units), stable unit sort by
    group id, level-2 emit expand (units → compact payload)."""
    from gsrt_torch.ops.pair_expand import (_DEAD_BASE, expand_pairs_binned,
                                            expand_pairs_fused)

    if ntx > 127 or nty >= (1 << 12):
        raise ValueError("tile grid exceeds the packed geometry word")
    dev = depth.device
    k = k_rows
    n_groups = -(-nty // k)
    live = touched > 0
    zeros = torch.zeros_like(x0)

    # --- depth sort: splats that emit pairs first, front to back ---
    key = torch.where(live, depth, torch.full_like(depth, float("inf")))
    rows_n = torch.where(live, y1 - y0 + 1, zeros)
    xy0g = x0 | (y0 << 7) | (rows_n << 19)
    w_spl = torch.where(live, x1 - x0 + 1, zeros + 1)
    l11, l21, l22 = conic_cholesky(qa_c, qb_c, qc_c)
    order = torch.argsort(key)
    xy0g, w_spl = xy0g[order], w_spl[order]
    qab = pack_bf16_pair(l11, l21)[order]
    qcd = pack_bf16_pair(l22, depth)[order]
    rgba = pack_rgba8(cr, cg, cb, opacity)[order]
    m2x_s, m2y_s = m2x[order], m2y[order]

    y0s = (xy0g >> 7) & 0xFFF
    rows_s = (xy0g >> 19) & 0xFFF
    units_n = torch.where(rows_s > 0,
                          (y0s + rows_s - 1) // k - y0s // k + 1, zeros)
    units_total = units_n.sum(dtype=torch.int32)
    uoff = torch.cumsum(units_n, 0, dtype=torch.int32)
    ubase = torch.where(units_n > 0, uoff - units_n,
                        torch.full_like(units_n, _DEAD_BASE))

    # --- level 1: splats -> (splat x row-group) units ---
    tab1 = torch.stack([xy0g, w_spl, ubase, m2x_s.view(torch.int32),
                        m2y_s.view(torch.int32), qab, qcd, rgba])
    e = expand_pairs_fused(tab1, ubase, max_units)             # [8, MU]
    geoA, w_e, ubase_e = e[0], e[1], e[2]
    uslot = torch.arange(max_units, dtype=torch.int32, device=dev)
    valid_u = uslot < torch.clamp_max(units_total, max_units)
    rank_u = torch.clamp_min(uslot - ubase_e, 0)
    x0_e = geoA & 0x7F
    y0_e = (geoA >> 7) & 0xFFF
    rows_e = (geoA >> 19) & 0xFFF
    gid = y0_e // k + rank_u
    ys = torch.maximum(y0_e, gid * k)
    ye = torch.minimum(y0_e + rows_e - 1, gid * k + (k - 1))
    rows_u = torch.where(valid_u, ye - ys + 1, torch.zeros_like(ys))

    # --- the sort: stable by group id at unit scale (dead units sink) ---
    ukey = torch.where(valid_u, gid, torch.full_like(gid, n_groups))
    perm = torch.sort(ukey, stable=True).indices
    rows_u = rows_u[perm]
    w_u = torch.clamp_min(w_e[perm] & 0x7F, 1)
    xgeo2 = x0_e[perm] | (ys[perm] << 12) | (w_e[perm] << 24)
    touched_u = torch.where(rows_u > 0, rows_u * w_u, torch.zeros_like(w_u))
    poff = torch.cumsum(touched_u, 0, dtype=torch.int32)
    pbase = torch.where(touched_u > 0, poff - touched_u,
                        torch.full_like(poff, _DEAD_BASE))

    # --- level 2: units -> compact payload ---
    tab2 = torch.cat([torch.stack([xgeo2, pbase]), e[3:8, perm]])
    payload = expand_pairs_binned(
        tab2.contiguous(), pbase, max_pairs,
        total=torch.clamp_max(total, max_pairs), ntx=ntx, T=T,
        tile_w=tile_w, tile_h=tile_h)                          # [5, MP]

    return TileBinning(
        payload=payload, tile_start=tile_start, tile_count=counts,
        total_pairs=total, overflow=overflow | (units_total > max_units),
        pair_depth=unpack_bf16_lo(payload[2]) if carry_depth else None)


def _build_f32_stream(
    depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb, x0, x1, y0,
    touched, *, ntx, T, max_pairs, expand_impl, with_ids, carry_depth,
    counts, tile_start, total, overflow,
) -> TileBinning:
    """Depth sort, then `_finish_f32` over the splats."""
    bits = lambda a: a.view(torch.int32)
    order, touched_s, base = _depth_order(depth, touched)
    rows = [x0, y0, torch.clamp_min(x1 - x0 + 1, 1), x0, bits(m2x),
            bits(m2y), bits(qa_c), bits(qb_c), bits(qc_c), pack15(cr, cg),
            pack15(cb, opacity)]
    if carry_depth:
        rows.append(bits(depth))
    tab = torch.stack(rows)[:, order]
    tab[3] = base
    return _finish_f32(
        tab, base, ntx=ntx, T=T, max_pairs=max_pairs,
        expand_impl=expand_impl, carry_depth=carry_depth, counts=counts,
        tile_start=tile_start, total=total, overflow=overflow,
        ids=(order, touched_s) if with_ids else None)


def _finish_f32(
    tab, base, *, ntx, T, max_pairs, expand_impl, carry_depth, counts,
    tile_start, total, overflow, ids=None,
) -> TileBinning:
    """Expand depth-ordered units → pairs, stable sort by tile id, f32
    payload [8, max_pairs]. A unit (a splat under rect spans, a tile row
    under ellipse spans) is a column of tab: 4 geometry rows (x0, y0,
    w_span, base), the 7 feature rows, and its camera depth bits with
    carry_depth. ids = (order, touched_s) of the depth sort fills the
    gradient-routing fields (with_ids)."""
    dev = tab.device
    rows = _expand_copy(tab, base, max_pairs, expand_impl)
    gx0, gy0, gw, gbase = rows[0], rows[1], rows[2], rows[3]

    slots = torch.arange(max_pairs, dtype=torch.int32, device=dev)
    valid = slots < torch.clamp_max(total, max_pairs)
    rank = torch.where(valid, slots - gbase, torch.zeros_like(slots))
    q = torch.div(rank, gw, rounding_mode="floor")
    tile = torch.where(valid, (gy0 + q) * ntx + gx0 + (rank - q * gw),
                       torch.full_like(slots, T))               # sentinel T

    # --- stable sort by tile: units are depth-ordered, so each tile's
    # segment stays front to back; dead slots sink to the tail ---
    tile_s, perm = torch.sort(tile, stable=True)
    dead = tile_s >= T
    feats = rows[4:4 + N_FEATURES][:, perm]
    feats = torch.where(dead[None, :], torch.zeros_like(feats), feats)
    order, touched_s = ids if ids is not None else (None, None)
    if ids is not None:
        row7 = torch.where(dead, torch.full_like(tile_s, max_pairs),
                           _i32(perm))
    else:
        row7 = tile_s | _PACK_BIAS
    payload = torch.cat([feats, row7[None, :]])
    return TileBinning(
        payload=payload, tile_start=tile_start, tile_count=counts,
        total_pairs=total, overflow=overflow,
        sorted_base=base if ids is not None else None,
        sorted_touched=touched_s,
        sorted_orig=_i32(order) if ids is not None else None,
        pair_depth=rows[11][perm].view(torch.float32) if carry_depth
        else None)


def ellipse_row_tiles(mx, my, qa, qb, qc, op, ty, x0, x1, *, tile_w: int,
                      tile_h: int, g_cutoff: float, alpha_threshold: float):
    """The tiles [tx0, tx1] of tile row ty that an ellipse span keeps, for
    a splat with mean (mx, my), conic [[a, b], [b, c]] and opacity op
    whose bounding box spans tiles [x0, x1]. With the cutoff G
    alpha-tightened as in `screen_extents_abc`, a·dx² + 2b·dy·dx + c·dy²
    ≤ 2G gives centre −b·dy/a (extremal at the row's ends) and half-width
    sqrt(2G·a − det·dy²)/a (largest at the dy nearest 0), both in f32,
    dilated 1e-3 px before the floor to tiles and clamped to [x0, x1]. A
    tile outside holds no pixel whose f32 alpha clears the threshold."""
    det = torch.clamp_min(qa * qc - qb * qb, 1e-18)
    qa_p = torch.clamp_min(qa, 1e-12)
    g = torch.clamp_max(torch.clamp_min(torch.log(torch.clamp_min(
        op / alpha_threshold, 1e-6)), 0.0), g_cutoff)
    dy_lo = ty.to(torch.float32) * tile_h - my
    dy_hi = dy_lo + (tile_h - 1)
    dy0 = torch.minimum(torch.clamp_min(dy_lo, 0.0), dy_hi)  # |dy|'s min
    two_g_a = torch.clamp_min(2.0 * g * qa, 0.0)
    wmax = torch.sqrt(torch.clamp_min(two_g_a - det * dy0 * dy0, 0.0)) \
        / qa_p + 1e-3
    slope = qb / qa_p
    xc_lo = mx - slope * dy_lo
    xc_hi = mx - slope * dy_hi
    dxmin = torch.minimum(xc_lo, xc_hi) - wmax
    dxmax = torch.maximum(xc_lo, xc_hi) + wmax

    def tile_x(v, lo, hi):
        # clamped as a float first: a saturating conversion, then the clip
        t = torch.clamp(torch.floor(v / tile_w), -2.0 ** 30, 2.0 ** 30)
        return torch.minimum(torch.maximum(_i32(t), lo), hi)

    tx0 = tile_x(dxmin, x0, x1)
    return tx0, tile_x(dxmax, tx0, x1)


def _build_ellipse(
    depth, m2x, m2y, qa_c, qb_c, qc_c, opacity, cr, cg, cb,
    x0, x1, y0, y1, touched, *, ntx, nty, T, tile_w, tile_h, max_pairs,
    max_rows, compact, expand_impl, carry_depth, g_cutoff, alpha_threshold,
) -> TileBinning:
    """Ellipse spans (`_build_ellipse` of the JAX package).

    Level 0 sorts the splats by depth; level 1 expands each into its
    bounding box's tile rows (the copy expand); each row then takes the
    ellipse's x-interval over its pixel rows (`ellipse_row_tiles`). The
    rows go through `_finish_compact` / `_finish_f32` as w_span × 1 units
    (level 2). The overflow flag covers the row buffer (max_rows) and the
    pair buffer. The level-1 table
    carries each field in an int32 row of its own, where the JAX package
    packs the geometry into 12/12/8-bit fields and pads the table to 16
    rows for the TPU."""
    from gsrt_torch.ops.pair_expand import _DEAD_BASE

    dev = depth.device
    bits = lambda a: a.view(torch.int32)
    live = touched > 0
    rows_n = torch.where(live, y1 - y0 + 1, torch.zeros_like(y1))

    # --- level 0: splats with rows first, front to back ---
    order, rows_s, row_base = _depth_order(depth, rows_n)
    rows_total = rows_s.sum(dtype=torch.int32)
    if compact:
        # rgba8888 packed from the raw f32 colours, bit-identical to the
        # rect stream's word
        cw = [pack_rgba8(cr, cg, cb, opacity)]
    else:
        cw = [pack15(cr, cg), pack15(cb, opacity)]
    op = torch.where(live, opacity, torch.zeros_like(opacity))
    tab = torch.stack([x0, x0, x1, y0, bits(m2x), bits(m2y), bits(qa_c),
                       bits(qb_c), bits(qc_c), bits(op)] + cw
                      + [bits(depth)])[:, order]
    tab[1] = row_base

    # --- level 1: splats → tile rows ---
    r = _expand_copy(tab, row_base, max_rows, expand_impl)
    f = lambda i: r[i].view(torch.float32)
    rx0, rbase, rx1, ry0 = r[0], r[1], r[2], r[3]
    mx, my, qa_r, qb_r, qc_r, op_r = f(4), f(5), f(6), f(7), f(8), f(9)
    depth_r = f(r.shape[0] - 1)
    rslot = torch.arange(max_rows, dtype=torch.int32, device=dev)
    rvalid = rslot < torch.clamp_max(rows_total, max_rows)
    ty = torch.where(rvalid, ry0 + (rslot - rbase), torch.zeros_like(ry0))

    # --- each row's x-interval of the ellipse ---
    zero = torch.zeros_like(rx0)
    tx0, tx1 = ellipse_row_tiles(mx, my, qa_r, qb_r, qc_r, op_r, ty, rx0,
                                 rx1, tile_w=tile_w, tile_h=tile_h,
                                 g_cutoff=g_cutoff,
                                 alpha_threshold=alpha_threshold)
    tx0 = torch.where(rvalid, tx0, zero)
    tx1 = torch.where(rvalid, tx1, zero)
    span = torch.where(rvalid, tx1 - tx0 + 1, zero)

    # --- per-tile counts from the one-row rects ---
    counts = tile_histogram(tx0, tx1, ty, ty, span > 0, ntx, nty).reshape(T)
    total = span.sum(dtype=torch.int32)
    overflow = (rows_total > max_rows) | (total > max_pairs)
    tile_start = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.cumsum(counts, 0, dtype=torch.int32)])
    tile_start = torch.minimum(tile_start, torch.clamp_max(total, max_pairs))
    pair_off = torch.cumsum(span, 0, dtype=torch.int32)
    base = torch.where(span > 0, pair_off - span,
                       torch.full_like(span, _DEAD_BASE))
    w_span = torch.clamp_min(span, 1)
    bk = dict(counts=counts, tile_start=tile_start, total=total,
              overflow=overflow, ntx=ntx, T=T, max_pairs=max_pairs,
              expand_impl=expand_impl, carry_depth=carry_depth)

    # --- level 2: rows → pairs ---
    if compact:
        l11, l21, l22 = conic_cholesky(qa_r, qb_r, qc_r)
        tab2 = torch.stack([
            tx0 | (ty << 12) | (w_span << 24), base, r[4], r[5],
            pack_bf16_pair(l11, l21),
            pack_bf16_pair(l22, torch.where(rvalid, depth_r,
                                            torch.zeros_like(depth_r))),
            r[10]])
        return _finish_compact(tab2, base, tile_w=tile_w, tile_h=tile_h,
                               **bk)
    rows2 = [tx0, ty, w_span, base] + [r[i] for i in range(4, 9)] \
        + [r[10], r[11]]
    if carry_depth:
        rows2.append(bits(torch.where(
            rvalid, depth_r, torch.full_like(depth_r, float("inf")))))
    return _finish_f32(torch.stack(rows2), base, **bk)
