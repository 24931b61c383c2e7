"""Screen-tile binned primary-ray triangle casting (counterpart of
`gsrt.ops.tri_binning`).

A camera ray's candidates are the triangles whose projected rectangle
covers its pixel: `build_tri_binning` bins projected triangle rects (or,
with `span_exact`, exact per-tile-row x-spans) to screen tiles, near-depth
sorts each tile's pairs by the triangle's nearest-vertex camera z, and
`cast_primary` runs a dense closest hit per tile segment that skips a
chunk once every pixel of the tile has a hit nearer than the chunk's
smallest z. On a CUDA tensor the cast launches `csrc/tri_cast.cu` (which
replaces the TPU kernel `_tri_cast_kernel`); on a CPU tensor it runs
`cast_primary_plain`. The kernel also skips, per warp of 32 pixels, the
pairs no direction of the warp can take (`warp_cull`, interval arithmetic
in the kernel's rounding), which changes no bit of the result.

Payload: f32 [11, max_pairs] rows 0-2 v0, 3-5 e1, 6-8 e2, 9 triangle id
(its int32 bits), 10 zmin. Dead columns carry zero geometry, the id
`_ID_SENTINEL` and zmin 3.4e38. The JAX payload's padding rows and its
chunk + 128 column tail exist for the TPU's DMA windows and are dropped.

Both run-expansions (triangles to pairs; with `span_exact`, triangles to
tile rows and rows to pairs) are the port's copy-mode expand
(`ops.pair_expand.expand_pairs_fused`, the Q2.1 kernel on the card). The
near-depth sort and the tile sort are stable, so equal-zmin triangles keep
their index order (the JAX package's depth sort is unstable: that order
is not contractual).
"""

from __future__ import annotations

import numpy as np
import torch

from gsrt_torch import _kernels
from gsrt_torch.ops.pair_expand import _DEAD_BASE, expand_pairs_fused
from gsrt_torch.ops.tile_binning import TileBinning, tile_extent, tile_histogram

TRI_ROWS = 11            # payload rows
CHUNK = 128              # pairs a cast stages and skips at once
WARP = 32                # pixels a warp of the cast kernel: its cull's box
_INF = 3.4e38            # the cast's "no hit" t and dead zmin
_ID_SENTINEL = 0x7FFFFFFF
_INF_BITS = int(np.array(_INF, np.float32).view(np.int32))


def _project(v, camera):
    """Pixel x, y and camera z of [N, 3] points, elementwise."""
    R = camera.view[:3, :3]
    tr = camera.view[:3, 3]
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    p = [R[i, 0] * x + R[i, 1] * y + R[i, 2] * z + tr[i] for i in range(3)]
    zs = torch.where(p[2] > 1e-4, p[2], torch.ones_like(p[2]))
    return (camera.fx * p[0] / zs + camera.cx,
            camera.fy * p[1] / zs + camera.cy, p[2])


def _exact_row_spans(ty, pv0, e1, e2, camera, tile_w: int, tile_h: int,
                     jitter_pad: float, rx0, rx1, rvalid):
    """Exact tile x-span of each (triangle, tile row) unit: the x-extent of
    the projected triangle over the row's y-band, attained at in-band
    vertices or edge/band crossings; rows behind the camera or with an
    empty band keep the rect span. Returns (tx0, tx1)."""
    proj = [_project(p, camera) for p in (pv0, pv0 + e1, pv0 + e2)]
    verts = [(x, y) for x, y, _ in proj]
    behind = torch.minimum(torch.minimum(proj[0][2], proj[1][2]),
                           proj[2][2]) <= 1e-4
    yb0 = ty.to(torch.float32) * tile_h - jitter_pad
    yb1 = yb0 + (tile_h - 1) + 2 * jitter_pad
    big = torch.full_like(yb0, 1e30)
    xmn, xmx = big, -big
    for xv, yv in verts:
        inb = (yv >= yb0) & (yv <= yb1)
        xmn = torch.minimum(xmn, torch.where(inb, xv, big))
        xmx = torch.maximum(xmx, torch.where(inb, xv, -big))
    for (xa, ya), (xb, yb) in ((verts[0], verts[1]), (verts[1], verts[2]),
                               (verts[2], verts[0])):
        dy = yb - ya
        steep = dy.abs() > 1e-12
        dy_s = torch.where(steep, dy, torch.full_like(dy, 1e-12))
        for ybnd in (yb0, yb1):
            t = (ybnd - ya) / dy_s
            ok = steep & (t >= 0.0) & (t <= 1.0)
            xi = xa + t * (xb - xa)
            xmn = torch.minimum(xmn, torch.where(ok, xi, big))
            xmx = torch.maximum(xmx, torch.where(ok, xi, -big))
    usable = rvalid & ~behind & (xmn <= xmx)
    tx0 = torch.floor((xmn - jitter_pad) / tile_w).to(torch.int32)
    tx0 = torch.minimum(torch.maximum(tx0, rx0), rx1)
    tx1 = torch.floor((xmx + jitter_pad) / tile_w).to(torch.int32)
    tx1 = torch.minimum(torch.maximum(tx1, tx0), rx1)
    return torch.where(usable, tx0, rx0), torch.where(usable, tx1, rx1)


def _run_base(runs: torch.Tensor) -> torch.Tensor:
    """Each source's first output column (runs > 0), else _DEAD_BASE."""
    off = torch.cumsum(runs, 0, dtype=torch.int32)
    return torch.where(runs > 0, off - runs, torch.full_like(off, _DEAD_BASE))


def build_tri_binning(v0, v1, v2, camera, *, tile_w: int, tile_h: int,
                      max_pairs: int, jitter_pad: float = 1.0,
                      span_exact: bool = False,
                      max_rows: int | None = None) -> TileBinning:
    """Bin [N, 3] triangles into per-tile pair lists, near-depth sorted.

    Triangles crossing the near plane get a full-screen rect; jitter_pad
    widens rects so jittered rays stay covered. span_exact expands
    triangles to tile rows first (max_rows of them, default max_pairs;
    needs nty <= 255) and clips each row to its exact x-span. tile_start /
    tile_count / total_pairs / overflow follow the JAX package's."""
    W, H = camera.width, camera.height
    ntx, nty = tile_extent(W, H, tile_w, tile_h)
    T = ntx * nty
    N = v0.shape[0]
    dev = v0.device
    i32 = lambda a: a.to(torch.int32)                          # noqa: E731

    x_a, y_a, z_a = _project(v0, camera)
    x_b, y_b, z_b = _project(v1, camera)
    x_c, y_c, z_c = _project(v2, camera)
    zmin = torch.minimum(torch.minimum(z_a, z_b), z_c)
    zmax = torch.maximum(torch.maximum(z_a, z_b), z_c)
    behind = zmin <= 1e-4
    alive = zmax > 1e-4
    xmin = torch.minimum(torch.minimum(x_a, x_b), x_c) - jitter_pad
    xmax = torch.maximum(torch.maximum(x_a, x_b), x_c) + jitter_pad
    ymin = torch.minimum(torch.minimum(y_a, y_b), y_c) - jitter_pad
    ymax = torch.maximum(torch.maximum(y_a, y_b), y_c) + jitter_pad
    zero = torch.zeros_like(xmin)
    xmin = torch.where(behind, zero, xmin)
    xmax = torch.where(behind, zero + W, xmax)
    ymin = torch.where(behind, zero, ymin)
    ymax = torch.where(behind, zero + H, ymax)
    alive = alive & (xmax >= 0) & (xmin < W) & (ymax >= 0) & (ymin < H)
    x0 = i32(torch.clamp(torch.floor(xmin / tile_w), 0, ntx - 1))
    x1 = i32(torch.clamp(torch.floor(xmax / tile_w), 0, ntx - 1))
    y0 = i32(torch.clamp(torch.floor(ymin / tile_h), 0, nty - 1))
    y1 = i32(torch.clamp(torch.floor(ymax / tile_h), 0, nty - 1))
    touched = torch.where(alive, (x1 - x0 + 1) * (y1 - y0 + 1),
                          torch.zeros_like(x0))

    # near-depth sort: the cast's early exit needs chunks in ascending zmin
    live = touched > 0
    order = torch.argsort(torch.where(live, zmin, torch.full_like(zmin,
                                                                  np.inf)),
                          stable=True)
    bits = lambda a: a.view(torch.int32)                       # noqa: E731
    e1, e2 = v1 - v0, v2 - v0
    zmin_f = torch.where(torch.isfinite(zmin), zmin,
                         torch.full_like(zmin, _INF))
    geom = [bits(c.contiguous()) for c in
            (v0[:, 0], v0[:, 1], v0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
             e2[:, 0], e2[:, 1], e2[:, 2])]
    tid = torch.arange(N, dtype=torch.int32, device=dev)

    if span_exact:
        if nty > 255:
            raise ValueError(f"exact spans take nty <= 255 tile rows, got "
                             f"{nty}")
        if max_rows is None:
            max_rows = max_pairs
        rows_n = torch.where(live, y1 - y0 + 1, torch.zeros_like(y0))[order]
        rows_total = rows_n.sum(dtype=torch.int32)
        row_base = _run_base(rows_n)
        tab1 = torch.stack([x0, x1, y0, x0] + geom
                           + [tid, bits(zmin_f)])[:, order].contiguous()
        tab1[3] = row_base
        rr = expand_pairs_fused(tab1, row_base, max_rows)   # [15, max_rows]
        rslot = torch.arange(max_rows, dtype=torch.int32, device=dev)
        rvalid = rslot < torch.clamp_max(rows_total, max_rows)
        ty = torch.where(rvalid, rr[2] + (rslot - rr[3]),
                         torch.zeros_like(rslot))
        f = lambda r: rr[r].view(torch.float32)                # noqa: E731
        pv0 = torch.stack([f(4), f(5), f(6)], 1)
        re1 = torch.stack([f(7), f(8), f(9)], 1)
        re2 = torch.stack([f(10), f(11), f(12)], 1)
        tx0, tx1 = _exact_row_spans(ty, pv0, re1, re2, camera, tile_w,
                                    tile_h, jitter_pad, rr[0], rr[1], rvalid)
        span = torch.where(rvalid, tx1 - tx0 + 1, torch.zeros_like(tx0))
        counts = tile_histogram(tx0, tx1, ty, ty, span > 0, ntx,
                                nty).reshape(T)
        total = span.sum(dtype=torch.int32)
        overflow = (rows_total > max_rows) | (total > max_pairs)
        zrow = torch.where(rvalid, rr[14], torch.full_like(rr[14],
                                                           _INF_BITS))
        tab = torch.cat([torch.stack([tx0, ty, torch.clamp_min(span, 1),
                                      _run_base(span)]), rr[4:14],
                         zrow[None]]).contiguous()
    else:
        counts = tile_histogram(x0, x1, y0, y1, live, ntx, nty).reshape(T)
        total = touched.sum(dtype=torch.int32)
        overflow = total > max_pairs
        touched_s = touched[order]
        tab = torch.stack([x0, y0, torch.clamp_min(x1 - x0 + 1, 1),
                           touched] + geom + [tid, bits(zmin_f)])
        tab = tab[:, order].contiguous()
        tab[3] = _run_base(touched_s)
    tile_start = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                            torch.cumsum(counts, 0, dtype=torch.int32)])
    tile_start = torch.minimum(tile_start, torch.clamp_max(total, max_pairs))

    rows = expand_pairs_fused(tab, tab[3].contiguous(), max_pairs)
    gx0, gy0, gw, gbase = rows[0], rows[1], rows[2], rows[3]
    slots = torch.arange(max_pairs, dtype=torch.int32, device=dev)
    valid = slots < torch.clamp_max(total, max_pairs)
    rank = torch.where(valid, slots - gbase, torch.zeros_like(slots))
    q = torch.div(rank, gw, rounding_mode="floor")
    tile = torch.where(valid, (gy0 + q) * ntx + gx0 + (rank - q * gw),
                       torch.full_like(slots, T))
    tile_s, perm = torch.sort(tile, stable=True)
    feats = rows[4:4 + TRI_ROWS][:, perm]
    dead = (tile_s >= T)[None, :]
    fill = torch.tensor([0] * 9 + [_ID_SENTINEL, _INF_BITS],
                        dtype=torch.int32, device=dev)[:, None]
    payload = torch.where(dead, fill, feats).view(torch.float32)
    return TileBinning(payload=payload, tile_start=tile_start,
                       tile_count=counts, total_pairs=total,
                       overflow=overflow)


def count_tri_pairs_numpy(v0, v1, v2, camera, *, tile_w: int, tile_h: int,
                          jitter_pad: float = 1.0,
                          span_exact: bool = False) -> int:
    """Host-side NumPy replica of build_tri_binning's pair count, for
    sizing max_pairs (the JAX package's function, line for line; in f64,
    so it may differ from the binning by the odd floor at a tile
    boundary: size with slack)."""
    v0, v1, v2 = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                  else np.asarray(t) for t in (v0, v1, v2))
    W, H = camera.width, camera.height
    ntx, nty = tile_extent(W, H, tile_w, tile_h)
    view = camera.view.detach().cpu().numpy()
    R, tr = view[:3, :3], view[:3, 3]
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)

    def proj(v):
        p = v @ R.T + tr
        z = p[:, 2]
        zs = np.where(z > 1e-4, z, 1.0)
        return (fx * p[:, 0] / zs + cx, fy * p[:, 1] / zs + cy, z)

    xa, ya, za = proj(v0)
    xb, yb, zb = proj(v1)
    xc, yc, zc = proj(v2)
    zmin = np.minimum(np.minimum(za, zb), zc)
    zmax = np.maximum(np.maximum(za, zb), zc)
    behind = zmin <= 1e-4
    alive = zmax > 1e-4
    xmin = np.minimum(np.minimum(xa, xb), xc) - jitter_pad
    xmax = np.maximum(np.maximum(xa, xb), xc) + jitter_pad
    ymin = np.minimum(np.minimum(ya, yb), yc) - jitter_pad
    ymax = np.maximum(np.maximum(ya, yb), yc) + jitter_pad
    xmin = np.where(behind, 0.0, xmin)
    xmax = np.where(behind, float(W), xmax)
    ymin = np.where(behind, 0.0, ymin)
    ymax = np.where(behind, float(H), ymax)
    alive &= (xmax >= 0) & (xmin < W) & (ymax >= 0) & (ymin < H)
    x0 = np.clip(np.floor(xmin / tile_w), 0, ntx - 1).astype(np.int64)
    x1 = np.clip(np.floor(xmax / tile_w), 0, ntx - 1).astype(np.int64)
    y0 = np.clip(np.floor(ymin / tile_h), 0, nty - 1).astype(np.int64)
    y1 = np.clip(np.floor(ymax / tile_h), 0, nty - 1).astype(np.int64)
    if not span_exact:
        return int(np.where(alive, (x1 - x0 + 1) * (y1 - y0 + 1), 0).sum())

    rows = np.where(alive, y1 - y0 + 1, 0)
    idx = np.repeat(np.arange(rows.shape[0]), rows)
    off = np.cumsum(rows) - rows
    ty = y0[idx] + (np.arange(idx.shape[0]) - off[idx])
    yb0 = ty * tile_h - jitter_pad
    yb1 = yb0 + (tile_h - 1) + 2 * jitter_pad
    big = 1e30
    xmn = np.full(idx.shape[0], big)
    xmx = np.full(idx.shape[0], -big)
    verts = [(xa[idx], ya[idx]), (xb[idx], yb[idx]), (xc[idx], yc[idx])]
    for xv, yv in verts:
        inb = (yv >= yb0) & (yv <= yb1)
        xmn = np.minimum(xmn, np.where(inb, xv, big))
        xmx = np.maximum(xmx, np.where(inb, xv, -big))
    for (xA, yA), (xB, yB) in ((verts[0], verts[1]), (verts[1], verts[2]),
                               (verts[2], verts[0])):
        dy = yB - yA
        dys = np.where(np.abs(dy) > 1e-12, dy, 1e-12)
        for ybnd in (yb0, yb1):
            t = (ybnd - yA) / dys
            ok = (np.abs(dy) > 1e-12) & (t >= 0.0) & (t <= 1.0)
            xi = xA + t * (xB - xA)
            xmn = np.minimum(xmn, np.where(ok, xi, big))
            xmx = np.maximum(xmx, np.where(ok, xi, -big))
    usable = ~behind[idx] & (xmn <= xmx)
    tx0 = np.clip(np.floor((xmn - jitter_pad) / tile_w), x0[idx], x1[idx])
    tx1 = np.clip(np.floor((xmx + jitter_pad) / tile_w), tx0, x1[idx])
    tx0 = np.where(usable, tx0, x0[idx])
    tx1 = np.where(usable, tx1, x1[idx])
    return int((tx1 - tx0 + 1).sum())


def _check_cast(binning: TileBinning, dirs, width, height, tile_w, tile_h):
    T = int(np.prod(tile_extent(width, height, tile_w, tile_h)))
    pay, ts = binning.payload, binning.tile_start
    if pay.dtype != torch.float32 or pay.dim() != 2 or \
            pay.shape[0] != TRI_ROWS:
        raise ValueError(f"payload must be f32 [{TRI_ROWS}, max_pairs]")
    if ts.dtype != torch.int32 or ts.shape != (T + 1,):
        raise ValueError(f"tile_start must be int32 [{T + 1}]")
    if dirs.shape != (height * width, 3) or dirs.dtype != torch.float32:
        raise ValueError(f"dirs must be f32 [{height * width}, 3]")
    npx = tile_w * tile_h
    if npx % 32 or npx > 1024:
        raise ValueError("tile_w * tile_h must be a multiple of 32, <= 1024")
    if not (pay.device == ts.device == dirs.device):
        raise ValueError("payload, tile_start and dirs must share a device")


def cast_primary(binning: TileBinning, dirs, origin, *, width: int,
                 height: int, tile_w: int, tile_h: int,
                 t_min: float = 1e-3, t_max: float = 1e4):
    """The binned primary cast. dirs [H·W, 3] world-space ray directions in
    framebuffer order, |d| ≈ 1 (zmin bounds t from below only for such
    rays); origin [3] the shared ray origin. Returns (t [H, W] f32, 3.4e38
    on a miss; tri_id [H, W] int32, _ID_SENTINEL on a miss). The origin is
    subtracted from v0 in f32, as the JAX package does (the kernel does it
    for the pairs it casts)."""
    _check_cast(binning, dirs, width, height, tile_w, tile_h)
    if not dirs.is_cuda:
        return cast_primary_plain(binning, dirs, origin, width=width,
                                  height=height, tile_w=tile_w,
                                  tile_h=tile_h, t_min=t_min, t_max=t_max)
    pay = binning.payload.contiguous()
    d = dirs.contiguous()
    o = origin.to(device=d.device, dtype=torch.float32).contiguous()
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    t = torch.empty((height, width), dtype=torch.float32, device=d.device)
    tid = torch.empty((height, width), dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):
        _kernels.TRI_CAST(pay.data_ptr(), pay.shape[1], o.data_ptr(),
                          binning.tile_start.data_ptr(), ntx * nty, ntx,
                          width, height, tile_w, tile_h, d.data_ptr(),
                          t_min, t_max, t.data_ptr(), tid.data_ptr(),
                          _kernels.stream_ptr(d))
    return t, tid


def _interval_scale(c, lo, hi):
    """c * [lo, hi], each end rounded to nearest; ends ordered by c's sign
    (a select, so NaN propagates)."""
    p, q = c * lo, c * hi
    pos = c >= 0
    return torch.where(pos, p, q), torch.where(pos, q, p)


def _interval_add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _interval_sub(a, b):
    return a[0] - b[1], a[1] - b[0]


def _interval_mul_signed(a, b, pos):
    """a * b where b > 0 throughout (pos) or b < 0 throughout."""
    (alo, ahi), (blo, bhi) = a, b
    lo = torch.where(pos, torch.where(alo >= 0, alo * blo, alo * bhi),
                     torch.where(ahi >= 0, ahi * blo, ahi * bhi))
    hi = torch.where(pos, torch.where(ahi >= 0, ahi * bhi, ahi * blo),
                     torch.where(alo >= 0, alo * bhi, alo * blo))
    return lo, hi


def cast_intervals(box, rec):
    """The cast kernel's warp-cull intervals: for a box of directions
    (three (lo, hi) pairs) and a pair's record (tvec, e1, e2, qvec, three
    each, and e2 . qvec), intervals holding every det, u, v and t that
    Möller–Trumbore, rounded as the kernel rounds it, gives a direction in
    the box. Rounding to nearest is monotone, so each end is the same
    f32 operation on the ends of its operands. Returns a dict of (lo, hi)
    tensors (u, v and t are meaningful where "signed": every det in the
    box is past ±1e-12 with one sign) and the "flat" mask (every |det| <=
    1e-12). Tensors broadcast; NaN propagates to the ends it touches."""
    dx, dy, dz = box
    tx, ty, tz, e1x, e1y, e1z, e2x, e2y, e2z, qx, qy, qz, e2q = rec
    sc, add, sub = _interval_scale, _interval_add, _interval_sub
    pvx = sub(sc(e2z, *dy), sc(e2y, *dz))
    pvy = sub(sc(e2x, *dz), sc(e2z, *dx))
    pvz = sub(sc(e2y, *dx), sc(e2x, *dy))
    det = add(add(sc(e1x, *pvx), sc(e1y, *pvy)), sc(e1z, *pvz))
    pos = det[0] > 1e-12
    inv = (1.0 / det[1], 1.0 / det[0])                 # 1/x falls
    u = _interval_mul_signed(add(add(sc(tx, *pvx), sc(ty, *pvy)),
                                 sc(tz, *pvz)), inv, pos)
    v = _interval_mul_signed(add(add(sc(qx, *dx), sc(qy, *dy)),
                                 sc(qz, *dz)), inv, pos)
    return dict(det=det, u=u, v=v, t=sc(e2q, *inv),
                flat=(det[0] >= -1e-12) & (det[1] <= 1e-12),
                signed=pos | (det[1] < -1e-12))


def warp_cull(box, rec, t_min: float, t_max: float, bound):
    """The cast kernel's cull of a pair for a warp, in its arithmetic: True
    where no direction in the box can accept the pair (every |det| <=
    1e-12; or, det of one sign, u < 0, v < 0, u + v > 1, t <= t_min or t
    >= t_max over the whole interval) or take it below `bound`, the warp's
    largest min(best t, running minimum) over its in-image lanes. A lane
    whose t exceeds its own min(best t, running minimum) cannot change its
    result, so the kernel's output does not change."""
    iv = cast_intervals(box, rec)
    u, v, t = iv["u"], iv["v"], iv["t"]
    return iv["flat"] | (iv["signed"] & (
        (u[1] < 0) | (v[1] < 0) | (u[0] + v[0] > 1) | (t[1] <= t_min)
        | (t[0] >= t_max) | (t[0] > bound)))


def moller_trumbore(d, rec, t_min: float, t_max: float):
    """Per ray, the cast's Möller–Trumbore as the kernel rounds it (each
    product and sum on its own): a dict of "ok" (accepted), "t", "det",
    "u" and "v". d is (dx, dy, dz), rec as in `cast_intervals`; tensors
    broadcast."""
    dx, dy, dz = d
    tx, ty, tz, e1x, e1y, e1z, e2x, e2y, e2z, qx, qy, qz, e2q = rec
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = det.abs() > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, torch.zeros_like(det))
    u = (tx * pvx + ty * pvy + tz * pvz) * inv_det
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = e2q * inv_det
    ok = (det_ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
          & (t < t_max))
    return dict(ok=ok, t=t, det=det, u=u, v=v)


def pair_records(v0r, e1, e2):
    """A pair's record as the kernel stages it: tvec = -v0r, e1, e2, qvec
    = tvec x e1 and e2 . qvec (13 tensors; v0r, e1, e2 each (x, y, z))."""
    tx, ty, tz = (-c for c in v0r)
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    e2q = e2x * qx + e2y * qy + e2z * qz
    return (tx, ty, tz, e1x, e1y, e1z, e2x, e2y, e2z, qx, qy, qz, e2q)


def warp_boxes(d, in_image):
    """Each warp's box of directions: d [..., 32, 3] and in_image [...,
    32] -> three (lo, hi) pairs [...]; lanes outside the image and NaN
    components stay out (an empty box is (inf, -inf))."""
    keep = in_image[..., None] & ~torch.isnan(d)
    inf = torch.full_like(d, np.inf)
    lo = torch.where(keep, d, inf).amin(-2)
    hi = torch.where(keep, d, -inf).amax(-2)
    return tuple((lo[..., i], hi[..., i]) for i in range(3))


def cast_primary_plain(binning: TileBinning, dirs, origin, *, width: int,
                       height: int, tile_w: int, tile_h: int,
                       t_min: float = 1e-3, t_max: float = 1e4,
                       stats: dict | None = None):
    """The plain PyTorch version of `cast_primary` on any device: each
    tile walks its segment in CHUNK-pair chunks from its start and skips a
    chunk when its smallest zmin is at least every pixel's best t (padding
    pixels past the image edge, whose direction is 0, included); within a
    chunk a pixel takes the smallest t, ties to the smallest id, and keeps
    it only when strictly below its best. `stats` receives the chunks and
    pairs cast ("chunks", "pairs"), the (warp, pair) steps of them for
    warps of 32 pixels ("warp_steps") and those the kernel's warp cull
    removes ("culled_steps", `warp_cull` per 32-pair batch)."""
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    T, npx = ntx * nty, tile_w * tile_h
    nw = npx // WARP
    dev = dirs.device
    d = dirs.reshape(height, width, 3)
    d = torch.nn.functional.pad(d, (0, 0, 0, ntx * tile_w - width, 0,
                                     nty * tile_h - height))
    d = d.reshape(nty, tile_h, ntx, tile_w, 3).permute(0, 2, 1, 3, 4)
    d = d.reshape(T, npx, 3)
    if stats is not None:
        gy = torch.arange(nty * tile_h, device=dev) < height
        gx = torch.arange(ntx * tile_w, device=dev) < width
        in_img = (gy[:, None] & gx[None, :]).reshape(
            nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3).reshape(T, npx)
        boxes = warp_boxes(d.reshape(T, nw, WARP, 3),
                           in_img.reshape(T, nw, WARP))
        has_px = in_img.reshape(T, nw, WARP).any(2)
    pay = binning.payload
    v0r = pay[0:3] - origin.to(torch.float32)[:, None]
    rows = torch.cat([v0r, pay[3:9]])                   # [9, L]
    ids_all = pay[9].view(torch.int32)
    zmin_all = pay[10]
    L = pay.shape[1]
    ts = binning.tile_start.long()
    n = ts[1:] - ts[:-1]
    n_chunks = (n + CHUNK - 1) // CHUNK
    best_t = torch.full((T, npx), _INF, device=dev)
    best_id = torch.full((T, npx), _ID_SENTINEL, dtype=torch.int32,
                         device=dev)
    lane = torch.arange(CHUNK, device=dev)
    batch = max(1, (1 << 24) // (npx * CHUNK))
    n_cast = n_pairs = warp_steps = culled = 0
    for c in range(int(n_chunks.max()) if T else 0):
        tiles = (n_chunks > c).nonzero()[:, 0]
        for s in range(0, tiles.numel(), batch):
            tl = tiles[s:s + batch]
            cols = ts[tl, None] + c * CHUNK + lane
            live = lane[None, :] < (n[tl, None] - c * CHUNK)
            cols = torch.clamp(cols, max=L - 1)
            zrow = torch.where(live, zmin_all[cols],
                               torch.full_like(zmin_all[cols], _INF))
            go = (best_t[tl] > zrow.amin(1)[:, None]).any(1)
            tl, cols, live = tl[go], cols[go], live[go]
            n_cast += tl.numel()
            n_pairs += live.sum()
            g = rows[:, cols][:, :, None, :]             # [9, b, 1, CHUNK]
            ids = ids_all[cols][:, None, :]
            db = d[tl]
            rec = pair_records(g[0:3], g[3:6], g[6:9])
            mt = moller_trumbore(
                tuple(db[:, :, i:i + 1] for i in range(3)), rec, t_min,
                t_max)
            tt = mt["t"]
            ok = mt["ok"] & live[:, None, :] & (ids != _ID_SENTINEL)
            tc = torch.where(ok, tt, torch.full_like(tt, _INF))
            m = tc.amin(2)
            im = torch.where(tc <= m[:, :, None], ids,
                             torch.full_like(ids, _ID_SENTINEL)).amin(2)
            bt = best_t[tl]
            if stats is not None:
                # the warp's bound at each batch's start: its in-image
                # lanes' largest min(best t, running minimum)
                run = tc.cummin(2).values[:, :, WARP - 1:CHUNK - 1:WARP]
                mu = torch.minimum(bt[:, :, None], torch.cat(
                    [torch.full_like(run[:, :, :1], _INF), run], 2))
                bound = torch.where(in_img[tl][:, :, None], mu,
                                    torch.full_like(mu, -np.inf))
                bound = bound.reshape(tl.numel(), nw, WARP,
                                      bound.shape[2]).amax(2)
                cut = warp_cull(
                    tuple((lo[tl][:, :, None], hi[tl][:, :, None])
                          for lo, hi in boxes), rec, t_min, t_max,
                    bound.repeat_interleave(WARP, 2))
                cut = cut | ~has_px[tl][:, :, None] | (ids == _ID_SENTINEL)
                warp_steps += nw * live.sum()
                culled += (cut & live[:, None, :]).sum()
            upd = (m < bt) & (m < _INF)
            best_t[tl] = torch.where(upd, m, bt)
            best_id[tl] = torch.where(upd, im, best_id[tl])
    if stats is not None:
        stats.update(chunks=n_cast, pairs=int(n_pairs),
                     warp_steps=int(warp_steps), culled_steps=int(culled))

    def unshuffle(a):
        a = a.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3)
        return a.reshape(nty * tile_h, ntx * tile_w)[:height, :width]
    return unshuffle(best_t), unshuffle(best_id)
