"""The group-contiguous compact stream's binning on the card.

`bin_group_stream` is the CUDA route of `tile_binning.build_tile_binning`
for the group stream: `csrc/tile_bin.cu`'s three launches (`bin_prep`,
`bin_gather`, `bin_units`) around the depth sort (the plain version's
`torch.argsort` of the same key) and the two expands of
`ops/pair_expand.py`. It returns the `TileBinning` that
`tile_binning.group_stream_plain` builds from the same columns on the
card, bit for bit. `build_tile_binning` takes it for CUDA tensors and the
plain version for CPU tensors; this function raises on anything the
kernels do not take.
"""

from __future__ import annotations

import torch

from gsrt_torch import _kernels
from gsrt_torch.ops import pair_expand
from gsrt_torch.ops.tile_binning import (TileBinning, group_rows_k,
                                         tile_extent, unpack_bf16_lo)

COLUMNS = ("depth", "m2x", "m2y", "qa", "qb", "qc", "opacity", "cr", "cg",
           "cb", "rx", "ry")
GATHER_THREADS = 1024      # bin_gather's block: one status word a block
UNIT_TILE = 1024           # bin_units' unit slots a block: a status word
                           # a tile and group


def _check(name: str, a: torch.Tensor, dtype, n: int, dev) -> None:
    if a.device != dev:
        raise ValueError(f"bin_group_stream: {name} is on {a.device}, "
                         f"depth on {dev}")
    if a.dtype != dtype:
        raise ValueError(f"bin_group_stream: {name} must be {dtype}, got "
                         f"{a.dtype}")
    if tuple(a.shape) != (n,):
        raise ValueError(f"bin_group_stream: {name} must have shape "
                         f"({n},), got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"bin_group_stream: {name} must be contiguous")


def workspace_layout(n: int, max_units: int, ntx: int, nty: int,
                     n_groups: int) -> dict:
    """Word offsets of the kernels' int32 workspace, each region 16-byte
    aligned (records are read as int4, status words as int64): the head up
    to "zero" is cleared by bin_prep (the corner grid, the sums, tickets
    and look-back status words); "end" is its length."""
    nb = n_groups + 1
    off, at = {}, 0
    for name, words in (
            ("grid", (nty + 1) * (ntx + 1)), ("sums", 4), ("tickets", 4),
            ("status", 2 * -(-n // GATHER_THREADS)), ("totals", 2 * nb),
            ("unit_status", 2 * -(-max_units // UNIT_TILE) * nb),
            ("zero", 0), ("key", n), ("rec", 8 * n), ("tab1", 8 * n),
            ("base", 2 * nb), ("end", 0)):
        off[name] = at
        at += -(-words // 4) * 4
    return off


def bin_group_stream(depth, m2x, m2y, qa, qb, qc, opacity, cr, cg, cb, rx,
                     ry, alive, *, width: int, height: int, tile_w: int,
                     tile_h: int, max_pairs: int, max_units: int,
                     keep: torch.Tensor | None = None,
                     carry_depth: bool = False) -> TileBinning:
    """The group stream of `build_tile_binning` (its arguments, with
    `max_units` for max_rows) from [N] float32 columns and the [N] bool
    `alive` on one CUDA device, all contiguous; `keep` [N] bool (serving's
    cull, optional) zeroes the splats it drops. Raises on another device,
    dtype, shape or layout, and on a tile grid the stream cannot pack."""
    cols = (depth, m2x, m2y, qa, qb, qc, opacity, cr, cg, cb, rx, ry)
    dev = depth.device
    if depth.dim() != 1:
        raise ValueError(f"bin_group_stream: depth must be [N], got shape "
                         f"{tuple(depth.shape)}")
    n = depth.shape[0]
    for name, a in zip(COLUMNS, cols):
        _check(name, a, torch.float32, n, dev)
    _check("alive", alive, torch.bool, n, dev)
    if keep is not None:
        _check("keep", keep, torch.bool, n, dev)
    ntx, nty = tile_extent(width, height, tile_w, tile_h)
    k = group_rows_k(ntx)
    if n < 1 or max_pairs < 1 or max_units < 1:
        raise ValueError(f"bin_group_stream needs splats and buffers: n={n}, "
                         f"max_pairs={max_pairs}, max_units={max_units}")
    if k is None or ntx > 127 or nty >= (1 << 12):
        raise ValueError(f"tile grid {ntx}x{nty} has no group stream")
    if dev.type != "cuda":
        raise ValueError(f"bin_group_stream runs on CUDA tensors, not {dev}; "
                         f"the plain version bins CPU tensors")
    T = ntx * nty
    n_groups = -(-nty // k)
    off = workspace_layout(n, max_units, ntx, nty, n_groups)
    ws = torch.empty(off["end"], dtype=torch.int32, device=dev)
    ptr = lambda name: ws.data_ptr() + 4 * off[name]          # noqa: E731
    key = ws[off["key"]:off["key"] + n].view(torch.float32)
    tab1 = ws[off["tab1"]:off["tab1"] + 8 * n].view(8, n)
    # meta: tile_start [T + 1], counts [T], total, min(total, max_pairs),
    # units_total
    meta = torch.empty(2 * T + 4, dtype=torch.int32, device=dev)
    overflow = torch.empty(1, dtype=torch.bool, device=dev)
    tab2 = torch.empty((7, max_units), dtype=torch.int32, device=dev)
    scalars = meta.data_ptr() + 4 * (2 * T + 1)
    with torch.cuda.device(dev):
        stream = _kernels.stream_ptr(depth)
        _kernels.BIN_PREP(
            *(c.data_ptr() for c in cols), alive.data_ptr(),
            None if keep is None else keep.data_ptr(), n, width, height,
            tile_w, tile_h, ntx, nty, k, max_pairs, max_units,
            ws.data_ptr(), 4 * off["zero"], ptr("grid"), ptr("sums"),
            ptr("key"), ptr("rec"), meta.data_ptr(),
            meta.data_ptr() + 4 * (T + 1), scalars, overflow.data_ptr(),
            stream)
        order = torch.argsort(key)
        _kernels.BIN_GATHER(order.data_ptr(), n, ptr("rec"), k, n_groups,
                            max_units, scalars, ptr("status"),
                            ptr("tickets"), ptr("totals"), ptr("base"),
                            tab1.data_ptr(), stream)
        e = pair_expand.expand_pairs_fused(tab1, tab1[2], max_units)
        _kernels.BIN_UNITS(e.data_ptr(), max_units, k, n_groups,
                           (n_groups + 1).bit_length(),
                           -(-max_units // UNIT_TILE), scalars, ptr("base"),
                           ptr("unit_status"), ptr("tickets") + 8,
                           tab2.data_ptr(), stream)
    payload = pair_expand.expand_pairs_binned(
        tab2, tab2[1], max_pairs, total=meta[2 * T + 2:2 * T + 3], ntx=ntx,
        T=T, tile_w=tile_w, tile_h=tile_h)
    return TileBinning(
        payload=payload, tile_start=meta[:T + 1],
        tile_count=meta[T + 1:2 * T + 1], total_pairs=meta[2 * T + 1],
        overflow=overflow[0],
        pair_depth=unpack_bf16_lo(payload[2]) if carry_depth else None)
