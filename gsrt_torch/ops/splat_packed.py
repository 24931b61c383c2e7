"""Front-to-back EWA blend of the packed pair streams.

Counterpart of `gsrt.ops.splat_packed.blend_packed`. On CUDA tensors it
launches `csrc/splat_packed.cu` (which replaces the TPU kernel
`_blend_packed_kernel`): the group kernel for the group-contiguous compact
stream (group_stream=True), the tile kernel for the tile-sorted stream
with the compact or the f32 payload. On CPU tensors it runs the plain
versions, per-tile loops of tensor code computing the same functions.

Semantics, shared by kernels and plain versions: each tile walks its pairs
in payload order (the per-tile depth order). The response is g = t1² + t2²
from the bf16 Cholesky factors (compact; the ½ folded in) or
½(a·dx² + 2b·dx·dy + c·dy²) from the f32 conic; alpha = min(op·e(g),
alpha_clamp) with e the exact exp(−g) or the reference's LUT, accepted when
alpha > alpha_threshold and, unless skip_range_check, 0 ≤ g ≤ g_cutoff
(then e(0) outside the range).

* Group stream: `partition_group_stream` lists each tile's columns of its
  group, in payload order (a stable sort by tile id, the id clamped into
  the group); each tile walks its own list in batches of BATCH pairs and
  stops before a batch when no pixel of it has trans > term_eps.
* Tile stream: the JAX kernel's chunk gate. The group's pairs fall into
  chunks of `chunk` columns from the group's chunk-aligned start; a tile's
  pairs in chunk j are blended iff the tile is unsaturated at j's start
  (some pixel, padding pixels included, has trans > term_eps), or j is
  the tile's last chunk and the column after its segment lies inside j
  and belongs to this group (a later tile, or the dead columns of a last
  group padded past T). `consumed` [G, bs] counts, per tile, the group's
  chunk starts at which the tile's max trans is ≥ term_eps (the group's
  chunk count for padding columns); `hits` [H, W] counts each pixel's
  accepted pairs in the chunks its tile blends. The group stream also
  gives hits, counted over the batches it blends.

Row cull (kernels only; it changes no output). A warp of the kernels is 32
consecutive pixels of a tile; before it runs a pair it tests a lower
bound of the pair's response over the warp's pixel rows (`row_cull`)
against the response above which the accept rule takes the pair nowhere
(`skip_bound`), and skips the pair when the bound exceeds it. The plain
versions count the (warp, pair) steps the cull removes in `stats`.
"""

from __future__ import annotations

import math

import torch

from gsrt_torch import _kernels
from gsrt_torch.ops import explut
from gsrt_torch.ops.tile_binning import (COMPACT_WIDTH, PAYLOAD_WIDTH,
                                         TileBinning, tile_extent,
                                         unpack15, unpack_bf16_hi,
                                         unpack_bf16_lo, unpack_mean_rel,
                                         unpack_rgba8)

_RH = 0.7071067811865476   # sqrt(1/2): folds the response's ½ into t1, t2
BATCH = 32                 # pairs a staged batch: the group stream's stop
PARTITION_SLICE = 4096     # columns a block of the partition kernels counts
_LUT_END = 255.0 / 32.0    # the exp LUT's last segment edge


def _check(binning: TileBinning, T: int, compact_only: bool) -> bool:
    """Validate the stream; returns whether the payload is compact."""
    pay, ts = binning.payload, binning.tile_start
    if pay.dtype != torch.int32 or ts.dtype != torch.int32:
        raise TypeError("payload and tile_start must be int32")
    rows = (COMPACT_WIDTH,) if compact_only else (COMPACT_WIDTH,
                                                  PAYLOAD_WIDTH)
    if pay.dim() != 2 or pay.shape[0] not in rows:
        raise ValueError(f"payload must be [{' or '.join(map(str, rows))}, "
                         f"L], got {tuple(pay.shape)}")
    if ts.shape != (T + 1,):
        raise ValueError(f"tile_start must be [{T + 1}], got "
                         f"{tuple(ts.shape)}")
    if pay.device != ts.device:
        raise ValueError("payload and tile_start must share a device")
    if not (pay.is_contiguous() and ts.is_contiguous()):
        raise ValueError("payload and tile_start must be contiguous")
    return pay.shape[0] == COMPACT_WIDTH


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


def decode_f32_pairs(cols: torch.Tensor) -> dict:
    """Decode f32 payload columns [8, n] into float32 fields."""
    f = lambda r: cols[r].view(torch.float32)
    cr, cg = unpack15(cols[5])
    cb, op = unpack15(cols[6])
    return dict(mx=f(0), my=f(1), qa=f(2), qb=f(3), qc=f(4),
                rgb=torch.stack([cr, cg, cb], -1), op=op)


def response(f: dict, px, py) -> torch.Tensor:
    """g [P, n] of a tile's pixels × its decoded pairs; px, py [P] in the
    payload's frame (tile-relative for compact, the image for f32), or
    [P, n] where each pair has pixels of its own."""
    dx = (px[:, None] if px.dim() == 1 else px) - f["mx"][None, :]
    dy = (py[:, None] if py.dim() == 1 else py) - f["my"][None, :]
    if "l11" in f:
        t1 = f["l11"][None, :] * dx + f["l21"][None, :] * dy
        t2 = f["l22"][None, :] * dy
        return t1 * t1 + t2 * t2
    return 0.5 * (f["qa"] * dx * dx + 2.0 * f["qb"] * dx * dy
                  + f["qc"] * dy * dy)


def alphas(gq, op, *, g_cutoff, alpha_threshold, alpha_clamp,
           skip_range_check, use_exp_lut):
    """(alpha [P, n], zero where not accepted; accept [P, n])."""
    expf = explut.exp_neg_lut if use_exp_lut else lambda v: torch.exp(-v)
    if skip_range_check:
        alpha = torch.clamp_max(op[None, :] * expf(gq), alpha_clamp)
        accept = alpha > alpha_threshold
    else:
        in_range = (gq >= 0.0) & (gq <= g_cutoff)
        alpha = torch.clamp_max(
            op[None, :] * expf(torch.where(in_range, gq,
                                           torch.zeros_like(gq))),
            alpha_clamp)
        accept = in_range & (alpha > alpha_threshold)
    return torch.where(accept, alpha, torch.zeros_like(alpha)), accept


def skip_bound(op, *, g_cutoff, alpha_threshold, skip_range_check,
               use_exp_lut, **_) -> torch.Tensor:
    """[n] float32: the response above which the accept rule takes the pair
    at no pixel. alpha's rule: ln(op / alpha_threshold) + 2^-10, the margin
    covering the kernels' expf and logf errors; under the exp LUT one
    segment (1/32) more while that stays inside the table (the LUT is at
    most expf at its segment's left edge), else none; with the range check
    also g_cutoff."""
    margin = torch.tensor(2.0 ** -10 - math.log(alpha_threshold)
                          if alpha_threshold > 0 else float("nan"),
                          dtype=torch.float32)
    gs = torch.log(op) + margin.to(op.device)
    if use_exp_lut:
        gs = torch.where(gs < _LUT_END, gs + 1.0 / 32.0,
                         torch.full_like(gs, float("inf")))
    if not skip_range_check:
        gs = torch.fmin(gs, torch.full_like(gs, g_cutoff))
    return gs


def conic_row_factor(qa, qb, qc) -> torch.Tensor:
    """[n] float32 q with the f32 response ≥ fl(q · fl(dy²)) at every dx,
    NaN where no bound is proven (`csrc/splat_packed.cu` derives it): the
    computed response is within 4.01u(1 + ρ)/(1 − ρ) of its exact value,
    ρ = |b|/√(ac) < 0.999, and at least ½(c − b²/a)dy²; in float64,
    rounded down."""
    a, b, c = (v.double() for v in (qa, qb, qc))
    rho = b.abs() / torch.sqrt(a * c)
    u = 2.0 ** -24
    eta = 8 * u * (1 + rho) / (1 - rho) + 4 * u
    q = 0.5 * (c - b * b / a) * (1 - eta)
    q32 = q.float()
    q32 = torch.where(q32.double() > q, torch.nextafter(
        q32, torch.full_like(q32, -float("inf"))), q32)
    ok = (a > 0) & (c > 0) & (rho < 0.999)
    return torch.where(ok, q32, torch.full_like(q32, float("nan")))


def warp_rows(sub_w: int, sub_h: int, device) -> tuple:
    """First and last pixel row (float32, tile-relative) of each of a
    tile's warps of 32 consecutive pixels."""
    w = torch.arange(sub_w * sub_h // 32, device=device)
    return ((32 * w) // sub_w).float(), ((32 * w + 31) // sub_w).float()


def row_cull(f: dict, rows: tuple, gs: torch.Tensor, oy=0.0
             ) -> torch.Tensor:
    """[warps, n] bool: the (warp, pair) steps the kernels skip. lb is the
    response's dy-term at the warp's row nearest the mean, rounded as the
    response rounds it: fl(fl(l22·dy)²) (compact: g = fl(t1²) + fl(t2²)
    ≥ fl(t2²), which grows with |dy|) or fl(q·fl(dy²)) (f32,
    `conic_row_factor`); a step is skipped when lb > gs. oy shifts the rows
    into the payload's frame: a number, or [n], one a pair."""
    ra, rb = rows[0][:, None] + oy, rows[1][:, None] + oy
    my = f["my"][None, :]
    dy = torch.clamp(my, ra, rb) - my
    if "l22" in f:
        t2 = f["l22"][None, :] * dy
        lb = t2 * t2
    else:
        lb = conic_row_factor(f["qa"], f["qb"], f["qc"])[None, :] * (dy * dy)
    return lb > gs[None, :]


def _blend_tile(f: dict, batch: torch.Tensor, px, py, *, term_eps, **kw):
    """One tile of the group stream: f holds the decoded fields of its n
    pairs in order, batch [n] each pair's batch index. Returns (color
    [P, 3], trans [P], hits [P], the number of pairs blended before the
    early stop)."""
    alpha, accept = alphas(response(f, px, py), f["op"], **kw)
    incl = torch.cumprod(1.0 - alpha, dim=1)
    excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=1)
    # trans at the start of each pair's batch, from the batch's first pair
    first = torch.searchsorted(batch, batch)
    live = (excl[:, first] > term_eps).any(dim=0)      # a prefix of pairs
    n_live = int(live.sum())
    hits = accept[:, :n_live].sum(1, dtype=torch.int32)
    if n_live == 0:
        return torch.zeros((px.shape[0], 3), device=px.device), \
            torch.ones_like(px), hits, 0
    w = (alpha * excl)[:, :n_live]
    return w @ f["rgb"][:n_live], incl[:, n_live - 1], hits, n_live


class _Frame:
    """Padded framebuffers a plain version fills tile by tile."""

    def __init__(self, ntx, nty, sub_w, sub_h, device):
        self.ntx, self.sub_w, self.sub_h = ntx, sub_w, sub_h
        self.color = torch.zeros((nty * sub_h, ntx * sub_w, 3), device=device)
        self.trans = torch.ones((nty * sub_h, ntx * sub_w), device=device)
        self.hits = torch.zeros((nty * sub_h, ntx * sub_w),
                                dtype=torch.int32, device=device)

    def put(self, tile, color, trans, hits):
        ty, tx = divmod(tile, self.ntx)
        ys, xs, h, w = ty * self.sub_h, tx * self.sub_w, self.sub_h, \
            self.sub_w
        self.color[ys:ys + h, xs:xs + w] = color.reshape(h, w, 3)
        self.trans[ys:ys + h, xs:xs + w] = trans.reshape(h, w)
        self.hits[ys:ys + h, xs:xs + w] = hits.reshape(h, w)

    def crop(self, width, height):
        return (self.color[:height, :width].contiguous(),
                self.trans[:height, :width].contiguous(),
                self.hits[:height, :width].contiguous())


def _tile_pixels(sub_w, sub_h, device):
    pidx = torch.arange(sub_w * sub_h, device=device)
    return ((pidx % sub_w).to(torch.float32),
            (pidx // sub_w).to(torch.float32))


def partition_group_stream_plain(tile_row: torch.Tensor,
                                 tile_start: torch.Tensor, T: int, bs: int):
    """Plain version of `partition_group_stream`: one stable sort of the
    clamped tile ids (groups follow each other, so it sorts each group)."""
    ts = tile_start.long()
    n = int(ts[T])
    dev = tile_row.device
    p = torch.arange(n, device=dev)
    g = torch.searchsorted(ts[0:T:bs].contiguous(), p, right=True) - 1
    g0 = g * bs
    key = torch.minimum(torch.maximum(tile_row[:n].long(), g0),
                        torch.clamp_max(g0 + bs, T) - 1)
    skey, idx = torch.sort(key, stable=True)
    order = torch.full((tile_row.shape[0],), -1, dtype=torch.int32,
                       device=dev)
    order[:n] = idx.to(torch.int32)
    seg = torch.searchsorted(skey, torch.arange(T + 1, device=dev))
    return order, seg.to(torch.int32)


def partition_group_stream(binning: TileBinning, T: int, bs: int):
    """Each tile's columns of the group stream: (order [L] int32, seg
    [T + 1] int32), tile t's columns at order[seg[t]:seg[t + 1]] in
    payload order. Group g (tiles [g0, g1), g0 = g·bs) owns the columns
    [tile_start[g0], tile_start[g1]); a column's key is its tile id clamped
    into [g0, g1), so a stream clamped at max_pairs still gives every
    column a segment. seg[g0] = tile_start[g0] and seg[T] = tile_start[T]
    (equal to tile_start throughout on an unclamped stream); order past
    seg[T] is unspecified. On CUDA tensors it launches the partition
    kernels of `csrc/splat_packed.cu` (one launch count), else runs the
    plain version."""
    pay, ts = binning.payload, binning.tile_start
    if not 0 < bs <= 512:
        raise ValueError("bs must be in [1, 512]")
    if not pay.is_cuda:
        return partition_group_stream_plain(pay[4], ts, T, bs)
    L = pay.shape[1]
    slices = -(-L // PARTITION_SLICE) + -(-T // bs)
    counts = torch.empty((slices, bs), dtype=torch.int32, device=pay.device)
    seg = torch.empty(T + 1, dtype=torch.int32, device=pay.device)
    order = torch.empty(L, dtype=torch.int32, device=pay.device)
    with torch.cuda.device(pay.device):
        _kernels.PARTITION(pay[4].data_ptr(), ts.data_ptr(), T, bs,
                           PARTITION_SLICE, slices, counts.data_ptr(),
                           seg.data_ptr(), order.data_ptr(),
                           _kernels.stream_ptr(pay))
    return order, seg


def blend_packed_plain(binning: TileBinning, *, width: int, height: int,
                       sub_w: int, sub_h: int, bs: int,
                       g_cutoff: float = 5.6,
                       alpha_threshold: float = 1.0 / 255.0,
                       alpha_clamp: float = 0.99, term_eps: float = 1e-4,
                       skip_range_check: bool = False,
                       use_exp_lut: bool = False, track_hits: bool = False,
                       stats: dict | None = None):
    """Plain version of the group-stream blend: (color [H, W, 3],
    trans [H, W]) float32, then hits [H, W] int32 with track_hits. A
    `stats` dict receives "pairs_blended", the pairs all tiles blend before
    their early stop (the data-dependent work a roofline bound counts),
    "warp_steps", those pairs times the tile's warps, and "culled_steps",
    the (warp, pair) steps of them the row cull skips."""
    ntx, nty = tile_extent(width, height, sub_w, sub_h)
    T = ntx * nty
    pay = binning.payload
    dev = pay.device
    px, py = _tile_pixels(sub_w, sub_h, dev)
    frame = _Frame(ntx, nty, sub_w, sub_h, dev)
    kw = dict(g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
              alpha_clamp=alpha_clamp, term_eps=term_eps,
              skip_range_check=skip_range_check, use_exp_lut=use_exp_lut)
    order, seg = partition_group_stream_plain(pay[4], binning.tile_start,
                                              T, bs)
    segl = seg.tolist()
    f_all = decode_pairs(pay[:, order[:segl[T]].long()])
    live = torch.zeros(segl[T], dtype=torch.bool, device=dev)
    for tile in range(T):
        lo, hi = segl[tile], segl[tile + 1]
        if hi <= lo:
            continue
        f = {k: v[lo:hi] for k, v in f_all.items()}
        batch = torch.arange(hi - lo, device=dev) // BATCH
        c, t, h, n_live = _blend_tile(f, batch, px, py, **kw)
        live[lo:lo + n_live] = True
        frame.put(tile, c, t, h)
    if stats is not None:
        rows = warp_rows(sub_w, sub_h, dev)
        cull = row_cull(f_all, rows, skip_bound(f_all["op"], **kw))
        blended = int(live.sum())
        stats.update(pairs_blended=blended,
                     warp_steps=blended * rows[0].numel(),
                     culled_steps=int((cull & live[None, :]).sum()))
    color, trans, hits = frame.crop(width, height)
    return (color, trans, hits) if track_hits else (color, trans)


def blend_packed_tile_plain(binning: TileBinning, *, width: int,
                            height: int, sub_w: int, sub_h: int, bs: int,
                            chunk: int, g_cutoff: float = 5.6,
                            alpha_threshold: float = 1.0 / 255.0,
                            alpha_clamp: float = 0.99,
                            term_eps: float = 1e-4,
                            skip_range_check: bool = False,
                            use_exp_lut: bool = False,
                            stats: dict | None = None):
    """Plain version of the tile-stream blend, either payload: (color
    [H, W, 3], trans [H, W], consumed [G, bs] int32, hits [H, W] int32).
    A `stats` dict receives "pairs_blended", the pairs in the chunks the
    tiles blend, "warp_steps", those pairs times the tile's warps, and
    "culled_steps", the (warp, pair) steps of them the row cull skips."""
    ntx, nty = tile_extent(width, height, sub_w, sub_h)
    T = ntx * nty
    G = -(-T // bs)
    pay = binning.payload
    dev = pay.device
    compact = pay.shape[0] == COMPACT_WIDTH
    decode = decode_pairs if compact else decode_f32_pairs
    lx, ly = _tile_pixels(sub_w, sub_h, dev)
    frame = _Frame(ntx, nty, sub_w, sub_h, dev)
    consumed = torch.zeros(G * bs, dtype=torch.int32)
    ts = binning.tile_start.tolist()
    kw = dict(g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
              alpha_clamp=alpha_clamp, skip_range_check=skip_range_check,
              use_exp_lut=use_exp_lut)
    rows = warp_rows(sub_w, sub_h, dev)
    blended = culled = 0
    for g0 in range(0, G * bs, bs):
        # the group's chunks start at its first pair, rounded down
        end_g = ts[min(g0 + bs, T)]
        astart = (ts[g0] // chunk) * chunk
        total_chunks = -(-(end_g - astart) // chunk)
        consumed[g0:g0 + bs] = total_chunks
        for tile in range(g0, min(g0 + bs, T)):
            lo, hi = ts[tile], ts[tile + 1]
            if hi <= lo:
                continue
            f = decode(pay[:, lo:hi])
            ty, tx = divmod(tile, ntx)
            px, py = (lx, ly) if compact else \
                (lx + tx * sub_w, ly + ty * sub_h)
            alpha, accept = alphas(response(f, px, py), f["op"], **kw)
            cull = row_cull(f, rows, skip_bound(f["op"], **kw),
                            0.0 if compact else float(ty * sub_h)) \
                if stats is not None else None
            trans = torch.ones_like(lx)
            color = torch.zeros((lx.shape[0], 3), device=dev)
            hits = torch.zeros(lx.shape[0], dtype=torch.int32, device=dev)
            jf, jl = (lo - astart) // chunk, (hi - 1 - astart) // chunk
            force_last = (hi - astart) % chunk != 0 and \
                (hi < end_g or g0 + bs > T)
            for j in range(jf, jl + 1):
                if bool((trans > term_eps).any()) or (j == jl and force_last):
                    a = max(lo, astart + j * chunk) - lo
                    b = min(hi, astart + (j + 1) * chunk) - lo
                    al = alpha[:, a:b]
                    incl = torch.cumprod(1.0 - al, dim=1)
                    excl = torch.cat([torch.ones_like(incl[:, :1]),
                                      incl[:, :-1]], dim=1)
                    color += (al * excl * trans[:, None]) @ f["rgb"][a:b]
                    trans = trans * incl[:, -1]
                    hits += accept[:, a:b].sum(1, dtype=torch.int32)
                    blended += b - a
                    if cull is not None:
                        culled += int(cull[:, a:b].sum())
                if consumed[tile] == total_chunks and \
                        not bool((trans >= term_eps).any()):
                    consumed[tile] = j + 1
            frame.put(tile, color, trans, hits)
    if stats is not None:
        stats.update(pairs_blended=blended,
                     warp_steps=blended * rows[0].numel(),
                     culled_steps=culled)
    color, trans, hits = frame.crop(width, height)
    return color, trans, consumed.reshape(G, bs).to(dev), hits


def blend_packed(binning: TileBinning, *, width: int, height: int,
                 sub_w: int = 32, sub_h: int = 16, bs: int = 120,
                 g_cutoff: float = 5.6,
                 alpha_threshold: float = 1.0 / 255.0,
                 alpha_clamp: float = 0.99, term_eps: float = 1e-4,
                 skip_range_check: bool = False, use_exp_lut: bool = False,
                 track_consumed: bool = False, track_hits: bool = False,
                 chunk: int = 128, group_stream: bool = True):
    """Run the packed blend: (color [H, W, 3], trans [H, W]) float32, then
    consumed [G, bs] int32 with track_consumed (the first chunk index at
    which each tile was saturated, the group's chunk count if never), then
    hits [H, W] int32 with track_hits. bs is the group size in tiles; on
    the group stream it is k full tile rows and `chunk` is not read (the
    port's group blend stops per batch of BATCH of a tile's own pairs,
    after `partition_group_stream`). The
    payload is the compact [5, L] or, on the tile stream, the f32 [8, L]
    one. The JAX kernel's scan_impl and math_dtype pick TPU arithmetic and
    have no counterpart: both streams blend in f32, pair by pair."""
    ntx, nty = tile_extent(width, height, sub_w, sub_h)
    T = ntx * nty
    compact = _check(binning, T, compact_only=group_stream)
    npx = sub_w * sub_h
    if npx % 32 != 0 or npx > 1024:
        raise ValueError("tile_w * tile_h must be a multiple of 32, <= 1024")
    if bs <= 0 or chunk <= 0:
        raise ValueError("bs and chunk must be positive")
    if group_stream and bs % ntx != 0:
        raise ValueError("a group must be whole tile rows (bs % ntx == 0)")
    if group_stream and track_consumed:
        raise ValueError(
            "track_consumed reads per-tile chunk positions, which the group "
            "stream does not have: serving blends the tile stream")
    kw = dict(g_cutoff=g_cutoff, alpha_threshold=alpha_threshold,
              alpha_clamp=alpha_clamp, term_eps=term_eps,
              skip_range_check=skip_range_check, use_exp_lut=use_exp_lut)
    pay, ts = binning.payload, binning.tile_start
    if not pay.is_cuda:
        if group_stream:
            return blend_packed_plain(binning, width=width, height=height,
                                      sub_w=sub_w, sub_h=sub_h, bs=bs,
                                      track_hits=track_hits, **kw)
        color, trans, consumed, hits = blend_packed_tile_plain(
            binning, width=width, height=height, sub_w=sub_w, sub_h=sub_h,
            bs=bs, chunk=chunk, **kw)
    else:
        dev = pay.device
        color = torch.empty((height, width, 3), dtype=torch.float32,
                            device=dev)
        trans = torch.empty((height, width), dtype=torch.float32, device=dev)
        hits = torch.empty((height, width), dtype=torch.int32, device=dev) \
            if track_hits else None
        hits_ptr = hits.data_ptr() if track_hits else None
        args = (g_cutoff, int(skip_range_check), alpha_threshold,
                alpha_clamp, term_eps, int(use_exp_lut))
        with torch.cuda.device(dev):
            if group_stream:
                order, seg = partition_group_stream(binning, T, bs)
                _kernels.BLEND_GROUP(
                    pay.data_ptr(), pay.shape[1], order.data_ptr(),
                    seg.data_ptr(), T, ntx, BATCH, width, height, sub_w,
                    sub_h, *args, color.data_ptr(), trans.data_ptr(),
                    hits_ptr, _kernels.stream_ptr(pay))
                return (color, trans, hits) if track_hits else (color, trans)
            G = -(-T // bs)
            consumed = torch.empty((G, bs), dtype=torch.int32, device=dev) \
                if track_consumed else None
            _kernels.BLEND_TILE(
                pay.data_ptr(), pay.shape[1], int(compact), ts.data_ptr(), T,
                ntx, bs, chunk, BATCH, width, height, sub_w, sub_h, *args,
                color.data_ptr(), trans.data_ptr(), hits_ptr,
                consumed.data_ptr() if track_consumed else None,
                _kernels.stream_ptr(pay))
    res = (color, trans)
    if track_consumed:
        res += (consumed,)
    if track_hits:
        res += (hits,)
    return res
